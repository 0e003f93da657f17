"""css_upload_gb_per_s (program span): the bytes the CSS engine uploaded
(the ``h2d_bytes`` counter: each ``SnpPair``'s codes copied to the card)
over the seconds of its ``css_upload`` span, summed over the window's
scans, in GB/s (1e9 bytes)."""


def read(run):
    if run.traffic["scan"] != "css" or not run.scans:
        return None
    nbytes = sum(s.counters.get("h2d_bytes", 0) for s in run.scans)
    secs = sum(s.timings_s.get("css_upload", 0.0) for s in run.scans)
    return nbytes / secs * 1e-9 if nbytes > 0 and secs > 0 else None
