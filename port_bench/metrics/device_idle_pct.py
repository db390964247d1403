"""Device (``device_idle_pct.frames``, ``device_idle_pct.train``): 100
minus the share of the traced window's wall time in which
an operation ran on the device (the union of its kernels, copies and
fills), the mean over the cards used, in %."""


def read(record):
    busy = record.get("summary", {}).get("busy_s")
    if not busy or not record.get("window_s"):
        return None
    share = sum(busy.values()) / len(busy) / record["window_s"]
    return 100.0 * (1.0 - share)
