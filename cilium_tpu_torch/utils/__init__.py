"""Infrastructure leaf packages (reference: pkg/{controller,trigger,
backoff,completion,spanstat,serializer,lock})."""

from .backoff import Backoff
from .completion import WaitGroup
from .controller import Controller, ControllerManager
from .serializer import FunctionQueue
from .spanstat import SpanStat
from .trigger import Trigger

__all__ = [
    "Backoff",
    "WaitGroup",
    "Controller",
    "ControllerManager",
    "FunctionQueue",
    "SpanStat",
    "Trigger",
]
