"""REST surface package. Lazy exports: sidecar processes import
api.client / api.unixhttp without dragging in the daemon (and with it
torch) through APIServer."""

__all__ = ["APIServer", "APIClient", "APIError"]


def __getattr__(name):
    if name == "APIServer":
        from .server import APIServer

        return APIServer
    if name in ("APIClient", "APIError"):
        from . import client

        return getattr(client, name)
    raise AttributeError(name)
