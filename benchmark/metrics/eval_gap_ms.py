"""eval_gap_ms: mean ms in which the device waits between one eval request
and the next, from the profiler's timeline: each request's read of its
answers shows as a run of device-to-host copies; the gap runs from the end
of the last other operation before the run to the start of the first after
it (the copies' own time inside it): the host's read and its dispatch of
the next request."""
READ = "Memcpy DtoH"


def read(run):
    if run.kind != "eval" or run.timeline is None:
        return None
    gaps, last_end, in_read = [], None, False
    for name, a, b in run.timeline.ops:
        if READ in name:
            in_read = True
            continue
        if in_read and last_end is not None:
            gaps.append(max(0.0, a - last_end) / 1e3)
        in_read = False
        last_end = b if last_end is None else max(last_end, b)
    return sum(gaps) / len(gaps) if gaps else None
