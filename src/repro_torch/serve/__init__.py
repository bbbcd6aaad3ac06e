"""Serving: the continuous-batching engine, its asyncio front end and the
serving-side helpers (counterpart of ``repro.serve``)."""
from .engine import (  # noqa: F401  # analyze: allow[deprecated-api] public shim re-export
    AdmissionPolicy,
    EDFAdmission,
    Engine,
    FCFSAdmission,
    PagedEngine,
    Request,
    TickPlan,
)
from .frontend import AsyncEngine, RequestHandle  # noqa: F401
from .steps import serve_config_of  # noqa: F401
