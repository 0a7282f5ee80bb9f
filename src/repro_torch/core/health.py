"""``tdp.health`` — numerical health guards for long-running programs.

A lattice service dies two ways: a *fault* (an executor raises) and a
*divergence* (a trajectory silently fills with NaN and keeps burning device
hours).  This module handles the second: opt-in checks between chunks that
turn "the fields are garbage" into a diagnosis — **which field**, what
**kind** of violation (``nan`` / ``inf`` / norm blow-up), which **member**
of an ensemble, over which **step range**::

    policy = tdp.HealthPolicy(fields=("g",), max_norm=1e3, every=4)
    state = compiled.run(state, 1000, health=policy)      # raises HealthError
    state = fleet.run(state, 1000, health=policy)         # member-attributed

The same object plugs into the service loop (``tdp.FleetDriver(...,
health=policy)``), where a diagnosed member is quarantined while every
healthy member keeps the exact result of the shared ensemble launch:
checks read state and never write it.

Cost: per guarded field, three reductions over the ``(members, -1)`` view
(any NaN, any Inf, the largest finite ``|x|``) where the field lies, then
one host read for the whole check.  The reference's guard is plain
``jnp``; so is this one, in PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple, Sequence

import torch

__all__ = ["HealthPolicy", "HealthError", "Diagnosis", "check", "diagnose"]


class Diagnosis(NamedTuple):
    """One member's first health violation: the offending field, the
    violation kind (``"nan"`` / ``"inf"`` / ``"norm"``), and the largest
    finite ``|x|`` observed (``None`` for nan/inf diagnoses)."""
    field: str
    kind: str
    value: float | None


class HealthError(RuntimeError):
    """A numerical health check failed.

    Carries the structured diagnosis alongside the message: ``field``,
    ``kind`` (``"nan"``/``"inf"``/``"norm"``), ``value`` (the offending
    finite max-``|x|`` for norm violations), ``member`` (ensemble slot,
    ``None`` for single-member states), ``step_range`` (the half-open
    member-step interval the divergence appeared in) and ``ticket`` (the
    fleet ticket id, when raised by the service driver).
    """

    def __init__(self, message: str, *, field: str | None = None,
                 kind: str | None = None, value: float | None = None,
                 member: int | None = None,
                 step_range: tuple[int, int] | None = None,
                 ticket: str | None = None):
        super().__init__(message)
        self.field = field
        self.kind = kind
        self.value = value
        self.member = member
        self.step_range = step_range
        self.ticket = ticket

    @classmethod
    def of(cls, diag: Diagnosis, *, member: int | None = None,
           step_range: tuple[int, int] | None = None,
           ticket: str | None = None, where: str | None = None,
           others: int = 0) -> "HealthError":
        """Build the human-facing message from a :class:`Diagnosis`."""
        what = (f"max |x| = {diag.value:.6g} exceeds max_norm"
                if diag.kind == "norm" else
                {"nan": "contains NaN", "inf": "contains Inf"}[diag.kind])
        ctx = []
        if member is not None:
            ctx.append(f"member {member}")
        if ticket is not None:
            ctx.append(f"ticket {ticket}")
        if step_range is not None:
            ctx.append(f"steps [{step_range[0]}, {step_range[1]})")
        msg = (f"numerical health check failed"
               f"{' for ' + where if where else ''}: "
               f"field {diag.field!r} {what}"
               f"{' (' + ', '.join(ctx) + ')' if ctx else ''}"
               + (f"; {others} other member(s) also diverged"
                  if others else ""))
        return cls(msg, field=diag.field, kind=diag.kind, value=diag.value,
                   member=member, step_range=step_range, ticket=ticket)


@dataclass(frozen=True)
class HealthPolicy:
    """What to guard and how often.

    Args:
      fields: field names to check (``None`` = every field present).
      nan / inf: flag non-finite values (both default on).
      max_norm: additionally flag any finite ``|x|`` above this bound (the
        norm-blow-up guard; ``None`` = off).
      every: check cadence in member steps — runs split into
        ``every``-step chunks with one check between chunks, so a diagnosis
        localises the divergence to an ``every``-wide step range.
    """

    fields: tuple[str, ...] | None = None
    nan: bool = True
    inf: bool = True
    max_norm: float | None = None
    every: int = 1

    def __post_init__(self):
        if self.fields is not None:
            object.__setattr__(self, "fields",
                               tuple(str(f) for f in self.fields))
        if int(self.every) < 1:
            raise ValueError(f"HealthPolicy.every must be >= 1, "
                             f"got {self.every}")
        object.__setattr__(self, "every", int(self.every))
        if self.max_norm is not None and not float(self.max_norm) > 0:
            raise ValueError(f"HealthPolicy.max_norm must be positive, "
                             f"got {self.max_norm}")
        if not (self.nan or self.inf or self.max_norm is not None):
            raise ValueError("HealthPolicy enables no checks (nan=False, "
                             "inf=False, max_norm=None) — it would pass "
                             "everything")

    def select_fields(self, available: Sequence[str]) -> list[str]:
        """The guarded subset of ``available``, in ``available`` order;
        raises when the policy names a field that does not exist."""
        avail = list(available)
        if self.fields is None:
            return avail
        missing = sorted(set(self.fields) - set(avail))
        if missing:
            raise ValueError(
                f"HealthPolicy names field(s) {missing} that the state "
                f"does not carry; present: {sorted(avail)}")
        want = set(self.fields)
        return [f for f in avail if f in want]


def _field_stats(a: torch.Tensor, ensemble: bool) -> torch.Tensor:
    """Per member ``(nan?, inf?, largest finite |x|)`` of one field, as a
    ``(members, 3)`` float64 tensor where the field lies: three reductions
    over the ``(members, -1)`` view."""
    x = a.reshape((a.shape[0], -1) if ensemble else (1, -1))
    if not x.is_floating_point():
        x = x.double()
    fmax = torch.where(torch.isfinite(x), x.abs(),
                       torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.stack([torch.isnan(x).any(1).double(),
                        torch.isinf(x).any(1).double(),
                        fmax.amax(1).double()], dim=1)


def diagnose(policy: HealthPolicy, state: Mapping[str, Any], *,
             ensemble: int | None = None) -> dict[int, Diagnosis]:
    """Check ``state`` against ``policy``; returns ``{member_index:
    Diagnosis}`` for every unhealthy member (empty dict = healthy).

    ``ensemble``: the leading ensemble extent of the field tensors, or
    ``None`` for single-member states (which report under index 0).  Per
    member, the *first* guarded field in state order wins, with kind
    priority nan > inf > norm.  Read-only; one host read for all fields.
    """
    nmembers = 1 if ensemble is None else int(ensemble)
    names = policy.select_fields(list(state))
    stats = []
    for f in names:
        a = torch.as_tensor(state[f])
        if ensemble is not None and (a.ndim < 1 or
                                     int(a.shape[0]) != nmembers):
            raise ValueError(
                f"health check: field {f!r} has leading extent "
                f"{a.shape[0] if a.ndim else '(scalar)'}, expected the "
                f"ensemble extent {nmembers}")
        stats.append(_field_stats(a, ensemble is not None))
    if not stats:
        return {}
    host = torch.stack(stats).cpu().tolist()
    out: dict[int, Diagnosis] = {}
    for f, rows in zip(names, host):
        if len(out) == nmembers:
            break
        for i, (nan, inf, fmax) in enumerate(rows):
            if i in out:
                continue
            if policy.nan and nan:
                out[i] = Diagnosis(f, "nan", None)
            elif policy.inf and inf:
                out[i] = Diagnosis(f, "inf", None)
            elif policy.max_norm is not None and \
                    fmax > float(policy.max_norm):
                out[i] = Diagnosis(f, "norm", fmax)
    return out


def check(policy: HealthPolicy, state: Mapping[str, Any], *,
          ensemble: int | None = None,
          step_range: tuple[int, int] | None = None,
          where: str | None = None) -> None:
    """Raise :class:`HealthError` (diagnosing the lowest unhealthy member)
    when ``state`` violates ``policy``; no-op when healthy."""
    diag = diagnose(policy, state, ensemble=ensemble)
    if not diag:
        return
    member, d = min(diag.items())
    raise HealthError.of(
        d, member=member if ensemble is not None else None,
        step_range=step_range, where=where, others=len(diag) - 1)
