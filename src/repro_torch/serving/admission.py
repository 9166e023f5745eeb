"""Per-tenant admission control and typed degradation policies.

Two pressure valves for the serving tier, applied in order:

1. **Admission** (:class:`AdmissionController`) — each tenant gets a token
   bucket (:class:`TokenBucket`) sized by its :class:`TenantPolicy`.  A
   ``submit`` that finds the bucket empty is rejected *at the door* with
   :class:`AdmissionRejected` before it can occupy queue space — an abusive
   tenant burns its own budget, not the shared queue.

2. **Degradation** (:class:`DegradationPolicy`) — once admitted, a drain
   under pressure trades answer quality for latency through an ordered list
   of typed steps (:class:`ShrinkK`, :class:`DropOversample`,
   :class:`SkipTail`), each armed at its own pressure threshold.  Steps
   transform a :class:`ProbeParams` and leave a label trail so degraded
   answers are never silent (``ProbeReport.degraded``).

Deadlines are enforced by the micro-batcher (drop-before-dispatch and
reject-after-late-completion) with :class:`DeadlineExceeded`; the exception
type lives here with the other serving-tier refusals.

Pure stdlib — no jax, no runtime imports; unit-testable with an injected
clock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.metrics import MetricsRegistry


class AdmissionRejected(RuntimeError):
    """Raised by ``submit`` when a tenant's token bucket is empty."""

    def __init__(self, tenant: str) -> None:
        super().__init__(f"tenant {tenant!r} over admission rate; probe rejected")
        self.tenant = tenant


class DeadlineExceeded(RuntimeError):
    """The query's deadline passed before its result could be served.

    Set on the submission Future either when the drainer drops an
    already-expired query (never dispatched) or when a probe completes
    after the deadline (computed but refused — never served silently
    late)."""

    def __init__(self, tenant: str, overrun_s: float) -> None:
        super().__init__(
            f"deadline exceeded for tenant {tenant!r} by {overrun_s * 1e3:.1f} ms"
        )
        self.tenant = tenant
        self.overrun_s = overrun_s


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity."""

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if rate <= 0:
            raise ValueError("rate must be > 0")
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()

    def try_acquire(self, n: float = 1.0) -> bool:
        now = self._clock()
        with self._lock:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


@dataclass(frozen=True)
class TenantPolicy:
    """Admission budget for one tenant.  ``rate_qps=None`` means unlimited
    (the tenant always admits — useful as a trusted-tenant default)."""

    rate_qps: Optional[float] = None
    burst: float = 16.0


class AdmissionController:
    """Token-bucket admission per tenant.

    ``policies`` maps tenant name → :class:`TenantPolicy`; tenants not in
    the map fall back to ``default`` (unlimited unless configured).  All
    decisions are counted per tenant in the attached registry
    (``admissions[t]`` / ``admission_rejected[t]``).
    """

    def __init__(
        self,
        policies: Optional[Dict[str, TenantPolicy]] = None,
        *,
        default: TenantPolicy = TenantPolicy(),
        clock: Callable[[], float] = time.monotonic,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.policies = dict(policies or {})
        self.default = default
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, Optional[TokenBucket]] = {}

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        with self._lock:
            if tenant not in self._buckets:
                policy = self.policies.get(tenant, self.default)
                self._buckets[tenant] = (
                    TokenBucket(policy.rate_qps, policy.burst, self._clock)
                    if policy.rate_qps is not None
                    else None  # unlimited
                )
            return self._buckets[tenant]

    def admit(self, tenant: str) -> bool:
        bucket = self._bucket(tenant)
        ok = bucket is None or bucket.try_acquire()
        name = "admissions" if ok else "admission_rejected"
        self.metrics.counter(name, tenant).inc()
        return ok


# -- degradation ----------------------------------------------------------

@dataclass(frozen=True)
class ProbeParams:
    """The knobs a degradation step may turn, in probe_batch terms."""

    k: int
    oversample: Optional[int] = None  # None → the index's configured value
    include_tail: bool = True


@dataclass(frozen=True)
class DegradeStep:
    """One typed quality/latency trade, armed at ``at_pressure`` ∈ [0, 1]."""

    at_pressure: float = 1.0

    def label(self) -> str:
        return type(self).__name__.lower()

    def apply(self, params: ProbeParams) -> ProbeParams:  # pragma: no cover
        raise NotImplementedError


@dataclass(frozen=True)
class ShrinkK(DegradeStep):
    """Halve (by ``factor``) the requested k, floored at ``min_k`` — the
    caller still gets its strongest neighbors, just fewer of them."""

    at_pressure: float = 0.5
    factor: float = 0.5
    min_k: int = 1

    def label(self) -> str:
        return f"shrink_k(x{self.factor:g})"

    def apply(self, params: ProbeParams) -> ProbeParams:
        k = max(self.min_k, int(params.k * self.factor))
        return replace(params, k=min(k, params.k))


@dataclass(frozen=True)
class DropOversample(DegradeStep):
    """Rerank only ``to``× k candidates instead of the index's configured
    oversample — cheaper stage B at a small recall cost."""

    at_pressure: float = 0.75
    to: int = 1

    def label(self) -> str:
        return f"drop_oversample(to={self.to})"

    def apply(self, params: ProbeParams) -> ProbeParams:
        return replace(params, oversample=max(1, self.to))


@dataclass(frozen=True)
class SkipTail(DegradeStep):
    """Skip the exact fresh-tail scan: serve from the indexed snapshot only
    (results may miss rows appended since the last index refresh)."""

    at_pressure: float = 0.9

    def label(self) -> str:
        return "skip_tail"

    def apply(self, params: ProbeParams) -> ProbeParams:
        return replace(params, include_tail=False)


def default_degradation_steps() -> Tuple[DegradeStep, ...]:
    return (ShrinkK(), DropOversample(), SkipTail())


@dataclass(frozen=True)
class DegradationPolicy:
    """Ordered degradation ladder: at pressure ``p`` every step with
    ``at_pressure <= p`` applies, mildest first."""

    steps: Tuple[DegradeStep, ...] = field(default_factory=default_degradation_steps)

    def plan(self, pressure: float) -> Tuple[DegradeStep, ...]:
        armed = [s for s in self.steps if pressure >= s.at_pressure]
        return tuple(sorted(armed, key=lambda s: s.at_pressure))

    def apply(
        self, params: ProbeParams, pressure: float
    ) -> Tuple[ProbeParams, Tuple[str, ...]]:
        """Run the armed steps over ``params``; returns the degraded params
        and the label trail (empty when nothing applied)."""
        labels: List[str] = []
        for step in self.plan(pressure):
            new = step.apply(params)
            if new != params:
                labels.append(step.label())
                params = new
        return params, tuple(labels)
