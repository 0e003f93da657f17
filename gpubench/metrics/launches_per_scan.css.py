"""launches_per_scan.css (program counter): the launches of the CSS
kernel wrappers (``kernels/css.py`` and ``kernels/perm.py`` LAUNCHES) over
the window, per scan."""


def read(run):
    if run.traffic["scan"] != "css" or not run.scans:
        return None
    return sum(run.launches.values()) / len(run.scans)
