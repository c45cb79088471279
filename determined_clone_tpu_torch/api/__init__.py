"""The master's API surface in the port: the in-process master
(``inprocess.py``). The REST client for the C++ master waits for the
control-plane hooks (``ROADMAP.md``, Queue 1, item 3.2)."""
from determined_clone_tpu_torch.api.inprocess import (
    InProcessMaster,
    InProcessSession,
    MasterError,
    MasterHTTPServer,
    serve_http,
)

__all__ = ["InProcessMaster", "InProcessSession", "MasterError",
           "MasterHTTPServer", "serve_http"]
