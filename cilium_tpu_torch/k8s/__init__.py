"""Kubernetes orchestrator integration (SURVEY §1 layer 9).

Translates k8s objects — NetworkPolicy, CiliumNetworkPolicy, Service,
Endpoints, Pod — into the framework's native models. Reference:
pkg/k8s/ (network_policy.go, rule_translate.go,
apis/cilium.io/utils/utils.go) and daemon/k8s_watcher.go.
"""

from .cnp import parse_cilium_rule, parse_cnp
from .constants import policy_labels
from .network_policy import parse_network_policy
from .pods import PodOrchestrator, pod_labels
from .rule_translate import RuleTranslator, preprocess_rules
from .service_registry import (
    ServiceEndpoint,
    ServiceID,
    ServiceInfo,
    ServicePort,
    ServiceRegistry,
)
from .watcher import K8sWatcher, load_objects, objects_to_rules

__all__ = [
    "K8sWatcher",
    "PodOrchestrator",
    "RuleTranslator",
    "ServiceEndpoint",
    "ServiceID",
    "ServiceInfo",
    "ServicePort",
    "ServiceRegistry",
    "load_objects",
    "objects_to_rules",
    "parse_cilium_rule",
    "parse_cnp",
    "parse_network_policy",
    "pod_labels",
    "policy_labels",
    "preprocess_rules",
]
