"""queue_wait_p90_ms.serve: the 90th percentile of the engine's own
``queue_wait_s`` (submit to admission into the running batch) over the
requests due in the window, in milliseconds."""
import numpy as np


def read(run):
    waits = run.stats.get("queue_wait_s")
    if not waits:
        return None
    return float(np.percentile(np.asarray(waits), 90)) * 1e3
