"""Shared arithmetic of the metric readers (``metrics/<name>.py``). A
reader returns None where its run holds nothing to read."""

from . import stats


def answers_per_s(rec):
    if not rec.requests:
        return None
    return stats.rate(rec.answers_done, rec.window_s)


def request_p95_ms(rec):
    if not rec.requests:
        return None
    return 1e3 * stats.percentile([d - c for c, _, d in rec.requests], 95)


def host_ms_per_answer(rec):
    if not rec.requests:
        return None
    return 1e3 * sum(r - c for c, r, _ in rec.requests) / rec.answers_done


def chains_ms_per_answer(rec):
    if rec.trace is None:
        return None
    return 1e3 * rec.trace.chains_s / rec.trace.answers


def kernel_roofline_pct(rec):
    if rec.trace is None or not rec.trace.port_s or not rec.bound_s:
        return None
    return 100.0 * rec.bound_s / rec.trace.port_s


def idle_pct(rec):
    if rec.trace is None:
        return None
    return rec.trace.idle_pct
