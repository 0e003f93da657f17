"""launches_per_scan.fet (program counter): the launches of the FET
kernel wrappers (``kernels/fet.py`` LAUNCHES) over the window, per genome
scan."""


def read(run):
    if run.traffic["scan"] != "fet" or not run.scans:
        return None
    return sum(run.launches.values()) / len(run.scans)
