from .registry import Node, NodeRegistry, NODES_PATH

__all__ = ["Node", "NodeRegistry", "NODES_PATH"]
