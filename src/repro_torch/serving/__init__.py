"""Trace-driven multi-tenant LLM serving on top of the MSched simulator.

The serving subsystem turns the static multitasking simulator into an
open-loop serving engine: request traces (Poisson / bursty / diurnal) become
dynamic task arrivals, each request runs a prefill→decode→EOS lifecycle as a
finite task, and an MSched-aware admission controller decides admit/queue/
reject from the predicted working sets and the scheduler timeline.

Copied from the JAX package's ``serving/__init__.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from repro_torch.serving.admission import (  # noqa: F401
    AlwaysAdmit,
    MSchedAdmission,
    footprint_pages,
    predicted_working_set_pages,
)
from repro_torch.serving.engine import (  # noqa: F401
    SLOSpec,
    ServeReport,
    build_events,
    serve_trace,
)
from repro_torch.serving.lifecycle import ServedRequestTask  # noqa: F401
from repro_torch.serving.traces import (  # noqa: F401
    GENERATORS,
    Request,
    Trace,
    bursty_trace,
    diurnal_trace,
    poisson_trace,
)
