"""Request lifecycle and admission-control types for ``SNNEventEngine``.

Counterpart of ``repro.serve.lifecycle``.

The serving layer promises that **every submission reaches exactly one
terminal state** — there is no silent-drop path and no unbounded queue.
The state machine:

    QUEUED ──admit──> RUNNING ──stream ends──> COMPLETED
      │  ▲              │
      │  └──re-admit────┤ (checkpoint restored at its step offset)
      │                 └─preempt──> PREEMPTED ──backoff──> (eligible again)
      ├──deadline passes before admission──> EXPIRED
      └──queue full, lowest priority──> REJECTED      (typed, at submit time)

plus the submit-time *typed* validation errors below, which reject a
malformed event tensor before it can reach a kernel launch (where it would
otherwise surface as an opaque shape error or silent garbage mid-round).

``RUNNING -> PREEMPTED -> RUNNING`` is invisible in the results: a
preempted request's slot state is checkpointed to host memory
(``snn.SlotCheckpoint``) and restored on re-admission at its recorded step
offset, and the fused kernel's ``row_ctl`` lane replays its noise streams
from exactly that offset — so the final logits/telemetry are bitwise
identical to a run that was never preempted.
"""

from __future__ import annotations

import numpy as np

# --- terminal + transient request states (EventRequest.state) --------------

QUEUED = "queued"          # submitted, waiting for a slot
RUNNING = "running"        # resident in a slot, advancing
PREEMPTED = "preempted"    # checkpointed to host, waiting for re-admission
COMPLETED = "completed"    # terminal: served, logits/telemetry populated
EXPIRED = "expired"        # terminal: deadline passed before completion
REJECTED = "rejected"      # terminal: shed by the bounded admission queue

TERMINAL_STATES = frozenset({COMPLETED, EXPIRED, REJECTED})


# --- typed submit-time validation errors -----------------------------------

class InvalidEventError(ValueError):
    """Base for submit-time event-tensor rejections (never reaches a kernel)."""


class EmptyEventError(InvalidEventError):
    """Zero-length event stream (T == 0, or an empty tensor)."""


class EventDtypeError(InvalidEventError):
    """Event tensor dtype the fused kernels cannot consume."""


class EventShapeError(InvalidEventError):
    """Event tensor is not (T, n_in) for this engine's config."""


class NonFiniteEventError(InvalidEventError):
    """Event tensor carries NaN/Inf values."""


class NonTernaryEventError(InvalidEventError):
    """Event values outside the ternary alphabet {-1, 0, +1}."""


class QueueFullError(RuntimeError):
    """Raised only by ``submit(..., shed=False)``; the default sheds instead."""


_ISSUE_ERRORS = {
    "dtype": EventDtypeError,
    "shape": EventShapeError,
    "empty": EmptyEventError,
    "nonfinite": NonFiniteEventError,
    "nonternary": NonTernaryEventError,
}


def validate_events(events, n_in: int | None = None) -> np.ndarray:
    """Validate one request's event tensor against the kernel contract.

    Delegates the actual checks to ``kernels.ops.event_stream_issues`` (the
    kernels own their input contract) and maps each issue code onto the
    typed exception hierarchy above, most severe first (dtype > shape >
    empty > nonfinite > nonternary).  Returns the host-side ``np.ndarray``
    view so callers can reuse it without re-materializing.
    """
    from repro_torch.kernels import ops as ops_lib   # late: keep import DAG thin
    ev, issues = ops_lib.event_stream_issues(events, n_in=n_in)
    for code in ("dtype", "shape", "empty", "nonfinite", "nonternary"):
        for got, detail in issues:
            if got == code:
                raise _ISSUE_ERRORS[code](detail)
    return ev
