"""L7 proxy management (reference: pkg/proxy)."""

from .accesslog import LogRecord, AccessLogServer
from .proxy import Proxy, Redirect

__all__ = ["Proxy", "Redirect", "LogRecord", "AccessLogServer"]
