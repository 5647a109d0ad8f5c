"""B1's share of its roofline: the least time of the window's
``score_fuse_batch`` calls (``bounds.score_fuse_work`` at each call's B, K
and U) over the device time those calls launched."""
UNIT = "%"


def read(run):
    if run.trace is None or not run.trace.device_s.get("score_fuse"):
        return None
    return (100.0 * run.work_s["score_fuse"]
            / run.trace.device_s["score_fuse"])
