"""B2's share of its roofline: the least time of the window's ``pool_scan``
calls (``bounds.pool_scan_work``, the lanes each request's scan read, from
its iteration count, which the judge holds against the reference's) over
the device time those calls launched, their prefix sums included."""
UNIT = "%"


def read(run):
    if run.trace is None or not run.trace.device_s.get("pool_scan"):
        return None
    return 100.0 * run.work_s["pool_scan"] / run.trace.device_s["pool_scan"]
