"""device_idle_share: the share of the profiled sub-window in which no
operation ran on the device (one minus the union of the device
intervals over the window), in percent."""


def read(run):
    summary = run.summary
    if summary is None or not summary.device or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
