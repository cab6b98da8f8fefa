"""k2.roofline_share: the least time of K2's work at the cell's shapes (one
card's share of a batch; gpubench/roofline.py counts it from the shapes,
against the card's published peaks) over K2's mean kernel time in the
trace, in percent."""
from gpubench.roofline import k2_work, least_time, peaks


def read(run):
    t = run.trace
    if not t:
        return None
    names = [k for k in t["kernel_n"] if "nuc_scores" in k]
    n = sum(t["kernel_n"][k] for k in names)
    if not n:
        return None
    mean = sum(t["kernel_s"][k] for k in names) / n
    s = run.shapes
    least, _ = least_time(*k2_work(s["B"], s["S"], s["W"], s["K"]), peaks(run.kind))
    return least / mean * 100.0
