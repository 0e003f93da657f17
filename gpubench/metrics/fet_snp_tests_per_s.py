"""fet_snp_tests_per_s (host clock): SNP tests (the SNPs of every
evaluated window, bench.py's "SNP FET test") of every genome scan, over the
whole window's seconds."""


def read(run):
    if run.traffic["scan"] != "fet":
        return None
    return sum(w["snp_tests"] for w in run.work) / run.window_s
