"""DNS poller: ToFQDNs names → generated ToCIDRSet rules.

Reference: pkg/fqdn/dnspoller.go — MarkToFQDNRules (:160) tags rules
carrying ToFQDNs, the 5s poll loop (:78) resolves every tracked name,
and on any IP-set change the generated ToCIDRSet entries are rebuilt
and re-injected through the repository (AddGeneratedRules → here the
pure-translator swap of Repository.translate_rules, one revision
bump). Resolution itself is pluggable — production uses the system
resolver, tests inject a fake (the reference does the same with its
lookup function, dnspoller.go LookupDNSNames).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..policy.api import CIDRRule, EgressRule, Rule
from ..policy.api.rules import host_cidr as _host_cidr
from .cache import DNSCache

# resolver signature: name → (ips, ttl_seconds)
Resolver = Callable[[str], Tuple[List[str], float]]

DEFAULT_INTERVAL = 5.0  # DNSPollerInterval (dnspoller.go:43)


def system_resolver(name: str) -> Tuple[List[str], float]:
    """Default resolver over the host stack (TTL is not surfaced by
    getaddrinfo — use a fixed re-poll horizon like the reference's
    fallback)."""
    import socket

    try:
        infos = socket.getaddrinfo(name, None)
    except OSError:
        return [], 0.0
    return sorted({i[4][0] for i in infos}), 60.0


class FQDNTranslator:
    """Pure rule translator: regenerates the fqdn-generated ToCIDRSet
    of every egress rule carrying ToFQDNs from the current cache
    state. User-written CIDRs and ToServices-generated entries are
    untouched (fqdn entries are tagged generated_by="fqdn")."""

    def __init__(self, cache: DNSCache, now: Optional[float] = None) -> None:
        self.cache = cache
        self.now = time.monotonic() if now is None else now

    def translate(self, rule: Rule) -> Rule:
        if not any(eg.to_fqdns for eg in rule.egress):
            return rule
        new_egress = []
        changed = False
        for eg in rule.egress:
            if not eg.to_fqdns:
                new_egress.append(eg)
                continue
            kept = tuple(
                c for c in eg.to_cidr_set if c.generated_by != "fqdn"
            )
            gen = []
            seen = set()
            for name in eg.to_fqdns:
                for ip in self.cache.lookup(name, self.now):
                    if ip in seen:
                        continue
                    seen.add(ip)
                    gen.append(
                        CIDRRule(
                            cidr=_host_cidr(ip),
                            generated=True,
                            generated_by="fqdn",
                        )
                    )
            new_set = kept + tuple(gen)
            if new_set != eg.to_cidr_set:
                changed = True
                new_egress.append(
                    dataclasses.replace(eg, to_cidr_set=new_set)
                )
            else:
                new_egress.append(eg)
        if not changed:
            return rule
        return dataclasses.replace(rule, egress=tuple(new_egress))


class DNSPoller:
    """Tracks ToFQDNs names across the repository and re-translates on
    IP-set change. ``repo`` needs Repository's rules/translate_rules
    surface; ``on_change`` (e.g. daemon regeneration) fires after a
    revision bump."""

    def __init__(
        self,
        repo,
        resolver: Resolver = system_resolver,
        cache: Optional[DNSCache] = None,
        on_change: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.repo = repo
        self.resolver = resolver
        self.cache = cache or DNSCache()
        self.on_change = on_change
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.failures = 0  # consecutive poll failures (operator signal)

    # -- name tracking (MarkToFQDNRules role) ---------------------------
    def tracked_names(self) -> List[str]:
        names = set()
        with self.repo._lock:
            rules = list(self.repo.rules)
        for r in rules:
            for eg in r.egress:
                names.update(eg.to_fqdns)
        return sorted(names)

    # -- polling --------------------------------------------------------
    def poll_once(self, now: Optional[float] = None) -> int:
        """One resolution sweep. Returns the number of rules whose
        generated CIDR set changed (0 = no revision bump)."""
        now = time.monotonic() if now is None else now
        for name in self.tracked_names():
            ips, ttl = self.resolver(name)
            if ips:
                self.cache.update(name, ips, ttl, now)
        self.cache.expire(now)
        # translation runs unconditionally: it is pure and cheap, a
        # no-op poll reports 0 changed (no revision bump), and gating
        # on cache change would miss rules imported since the last
        # translate (the reference solves that with MarkToFQDNRules at
        # import time; unconditional translate covers the same gap)
        rev, changed = self.repo.translate_rules(FQDNTranslator(self.cache, now))
        if changed and self.on_change is not None:
            self.on_change(rev)
        return changed

    def start(self, interval: float = DEFAULT_INTERVAL) -> None:
        if self._thread is not None:
            return

        log = logging.getLogger("cilium_tpu.fqdn")
        # fresh Event per loop (see health/prober.py start): a restart
        # after a timed-out join must not revive the old thread
        self._stop = stop_ev = threading.Event()

        def loop():
            while not stop_ev.wait(interval):
                try:
                    self.poll_once()
                    self.failures = 0
                except Exception:
                    # poller must survive resolver hiccups — log and
                    # keep polling (dnspoller.go does the same); the
                    # failure counter gives status surfaces a signal
                    self.failures += 1
                    log.warning("fqdn poll failed (%d consecutive)",
                                self.failures, exc_info=True)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
