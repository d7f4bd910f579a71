"""The CNI EXECUTABLE protocol — what kubelet actually invokes.

Reference: plugins/cilium-cni/cilium-cni.go is a binary speaking the
CNI spec: command in ``CNI_COMMAND``, container/netns/ifname in env,
network config JSON on stdin, result (or structured error) JSON on
stdout. This module is that binary:

    CNI_COMMAND=ADD CNI_CONTAINERID=abc \
    CNI_NETNS=/var/run/netns/pod1 CNI_IFNAME=eth0 \
    python -m cilium_tpu_torch.plugins.cni_exec < net.conf

It talks to the local agent over its API socket (the reference's
client → cilium-agent flow): IPAM allocation + endpoint registration
remotely, interface plumbing locally (plugins/netns.py). Config keys:
``socket`` (agent API socket path; default /var/run/cilium-tpu.sock).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

CNI_VERSION = "0.4.0"
SUPPORTED = ["0.3.0", "0.3.1", "0.4.0"]

# CNI well-known error codes (spec §Error)
ERR_INCOMPATIBLE_VERSION = 1
ERR_UNSUPPORTED_FIELD = 2
ERR_UNKNOWN_CONTAINER = 3
ERR_INVALID_ENV = 4
ERR_IO = 5
ERR_DECODE = 6
ERR_INTERNAL = 7
ERR_TRY_LATER = 11


class CNIFault(Exception):
    def __init__(self, code: int, msg: str, details: str = "") -> None:
        super().__init__(msg)
        self.code = code
        self.msg = msg
        self.details = details


def _emit(obj: Dict) -> None:
    sys.stdout.write(json.dumps(obj))
    sys.stdout.flush()


def _fail(e: CNIFault) -> int:
    _emit({
        "cniVersion": CNI_VERSION,
        "code": e.code,
        "msg": e.msg,
        "details": e.details,
    })
    return 1


def _alias_for(cni_netns: str) -> str:
    """DETERMINISTIC alias for a non-named netns path: retries and DEL
    must land on the same name (a per-process hash would mint a new
    never-detached bind mount per invocation, pinning the pod's netns
    alive in the kernel)."""
    import hashlib

    return "cni-" + hashlib.sha256(cni_netns.encode()).hexdigest()[:10]


def _netns_name(cni_netns: str) -> str:
    """CNI hands a PATH; iproute2 wants a NAME. /var/run/netns/<name>
    (and /run/netns/<name>) map directly; any other path (e.g.
    /proc/<pid>/ns/net) is aliased via ``ip netns attach`` and
    detached again by _detach_alias (DEL / ADD-failure paths)."""
    from . import netns as nsmod

    for prefix in ("/var/run/netns/", "/run/netns/"):
        if cni_netns.startswith(prefix):
            return cni_netns[len(prefix):]
    alias = _alias_for(cni_netns)
    proc = nsmod._run("netns", "attach", alias, cni_netns, check=False)
    # EEXIST from a prior invocation's attach is fine — same alias
    # name means the same path by construction
    if proc.returncode != 0 and "File exists" not in proc.stderr:
        raise CNIFault(
            ERR_INVALID_ENV,
            f"cannot use netns path {cni_netns!r}",
            proc.stderr.strip(),
        )
    return alias


def _detach_alias(cni_netns: str) -> None:
    """Remove the attach-created bind mount (no-op for named paths)."""
    from . import netns as nsmod

    for prefix in ("/var/run/netns/", "/run/netns/"):
        if cni_netns.startswith(prefix):
            return
    nsmod.delete_netns(_alias_for(cni_netns))


def _labels_from_args(cni_args: str, container_id: str) -> List[str]:
    """CNI_ARGS K8S_POD_NAMESPACE/K8S_POD_NAME → the identity labels
    the reference derives for the pod (cilium-cni.go + pkg/k8s)."""
    kv = dict(
        part.split("=", 1) for part in cni_args.split(";")
        if "=" in part
    )
    labels = [f"container:id={container_id[:12]}"]
    ns = kv.get("K8S_POD_NAMESPACE")
    name = kv.get("K8S_POD_NAME")
    if ns:
        labels.append(f"k8s:io.kubernetes.pod.namespace={ns}")
    if name:
        labels.append(f"k8s:io.kubernetes.pod.name={name}")
    return labels


def _agent(conf: Dict):
    from ..api.client import APIClient

    sock = conf.get("socket") or "/var/run/cilium-tpu.sock"
    if not os.path.exists(sock):
        raise CNIFault(
            ERR_TRY_LATER, f"agent socket {sock} not present"
        )
    return APIClient(sock, timeout=30.0)


def _cmd_add(env: Dict[str, str], conf: Dict) -> Dict:
    from . import netns as nsmod
    from .cni import endpoint_id_for, gateway_for, host_ifname

    container_id = env["CNI_CONTAINERID"]
    ifname = env.get("CNI_IFNAME", "eth0")
    netns = _netns_name(env["CNI_NETNS"])
    client = _agent(conf)
    ep_id = endpoint_id_for(container_id)
    try:
        alloc = client.ipam_allocate(owner=container_id)
    except Exception as e:
        raise CNIFault(ERR_TRY_LATER, f"IPAM allocation failed: {e}")
    ip = alloc["ip"]
    gateway = gateway_for(alloc["cidr"])
    host_if = host_ifname(ep_id)

    def rollback(release_ip: bool, drop_link: bool) -> None:
        if drop_link:
            nsmod.delete_link(host_if)
        if release_ip:
            try:
                client.ipam_release(ip)
            except Exception:
                pass
        _detach_alias(env["CNI_NETNS"])

    try:
        nsmod.create_endpoint_veth(
            host_if, netns, f"{ip}/32",
            container_if=ifname, gateway=gateway,
        )
    except Exception as e:
        rollback(release_ip=True, drop_link=False)
        raise CNIFault(ERR_INTERNAL, f"interface create failed: {e}")
    try:
        client.endpoint_put(
            ep_id,
            _labels_from_args(env.get("CNI_ARGS", ""), container_id),
            ipv4=ip,
        )
    except Exception as e:
        rollback(release_ip=True, drop_link=True)
        raise CNIFault(ERR_INTERNAL, f"endpoint create failed: {e}")
    return {
        "cniVersion": conf.get("cniVersion", CNI_VERSION),
        "interfaces": [
            {"name": host_if},
            {"name": ifname, "sandbox": env["CNI_NETNS"]},
        ],
        "ips": [{
            "version": "4",
            "interface": 1,
            "address": f"{ip}/32",
            "gateway": gateway,
        }],
        "routes": [{"dst": "0.0.0.0/0", "gw": gateway}],
        "dns": {},
    }


def _cmd_del(env: Dict[str, str], conf: Dict) -> Dict:
    from . import netns as nsmod
    from .cni import endpoint_id_for, host_ifname

    container_id = env["CNI_CONTAINERID"]
    ep_id = endpoint_id_for(container_id)
    nsmod.delete_link(host_ifname(ep_id))
    if env.get("CNI_NETNS"):  # detach any attach-created alias mount
        _detach_alias(env["CNI_NETNS"])
    # DEL must succeed even when the agent never saw this container
    # (CNI spec) — and even when the agent is down, interface cleanup
    # above already happened
    try:
        _agent(conf).endpoint_delete(ep_id)
    except Exception:
        pass
    return {}


def main(environ=None, stdin=None) -> int:
    env = dict(environ if environ is not None else os.environ)
    command = env.get("CNI_COMMAND", "")
    try:
        if command == "VERSION":
            _emit({
                "cniVersion": CNI_VERSION,
                "supportedVersions": SUPPORTED,
            })
            return 0
        raw = (stdin if stdin is not None else sys.stdin).read()
        try:
            conf = json.loads(raw) if raw.strip() else {}
        except ValueError as e:
            raise CNIFault(ERR_DECODE, f"bad network config: {e}")
        if command not in ("ADD", "DEL", "CHECK"):
            raise CNIFault(
                ERR_INVALID_ENV, f"unsupported CNI_COMMAND {command!r}"
            )
        want = conf.get("cniVersion")
        if want and want not in SUPPORTED:
            # a later spec's result schema differs — returning a
            # 0.4.0-shaped result stamped with their version would
            # break libcni parsing; the spec mandates error code 1
            raise CNIFault(
                ERR_INCOMPATIBLE_VERSION,
                f"cniVersion {want!r} not supported "
                f"(supported: {', '.join(SUPPORTED)})",
            )
        for key in ("CNI_CONTAINERID",) + (
            ("CNI_NETNS",) if command == "ADD" else ()
        ):
            if not env.get(key):
                raise CNIFault(ERR_INVALID_ENV, f"missing {key}")
        if command == "ADD":
            _emit(_cmd_add(env, conf))
        elif command == "DEL":
            _cmd_del(env, conf)
        else:  # CHECK: the endpoint must exist
            from ..api.client import APIError
            from .cni import endpoint_id_for

            ep_id = endpoint_id_for(env["CNI_CONTAINERID"])
            client = _agent(conf)  # CNIFault(TRY_LATER) when absent
            try:
                client.endpoint_get(ep_id)
            except APIError as e:
                if e.status == 404:
                    raise CNIFault(
                        ERR_UNKNOWN_CONTAINER,
                        f"no endpoint for {env['CNI_CONTAINERID'][:12]}",
                    )
                raise CNIFault(ERR_TRY_LATER, f"agent error: {e}")
            except OSError as e:
                # agent restarting/unreachable is NOT "unknown
                # container" — that answer would make the runtime tear
                # down a healthy pod instead of retrying
                raise CNIFault(ERR_TRY_LATER, f"agent unreachable: {e}")
        return 0
    except CNIFault as e:
        return _fail(e)
    except Exception as e:  # never tracebacks at kubelet
        return _fail(CNIFault(ERR_INTERNAL, f"{type(e).__name__}: {e}"))


if __name__ == "__main__":
    sys.exit(main())
