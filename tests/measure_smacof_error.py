"""K6's float32 error on the card against its plain version, for this
tree's package or another's: css_smacof and css_smacof_plain in fast mode
on the envelope cell of chip_smoke.py's phase 16a (10 k SNPs / 500 kbp,
seed 11, the valid windows at 2500 / 500 bp, run_css's default key), at
70 + 58 and 110 + 90, modes 1 and 2.  For each it prints the maximum and
the 90th percentile of |kernel - plain| / max(|plain|, 1) over the
windows both keep (chip_smoke.py's fast-mode band statistics), on all
windows and on the first 128, with the windows whose chosen restart or
transform count differ.  On a machine with a card and nvcc:

    python tests/measure_smacof_error.py [--tree DIR]

(--tree: the root of another checkout, e.g. an earlier commit unpacked by
``git archive`` into a gitignored directory; its divergence_tpu_torch is
imported and built in place of this tree's.)"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

FIRST = 128


def stats(rel: torch.Tensor) -> str:
    if rel.numel() == 0:
        return "no windows"
    return f"max {float(rel.max()):.3e}, q90 {float(torch.quantile(rel, 0.9)):.3e}"


def main() -> None:
    from divergence_tpu_torch import rng
    from divergence_tpu_torch.core.windows import plan_windows
    from divergence_tpu_torch.engine import SnpPair
    from divergence_tpu_torch.kernels import css as kcss
    from divergence_tpu_torch.tools.synth import make_chromosome

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(f"{card}; {Path(kcss.__file__).resolve().parent.parent}")
    key = rng.fold_in(rng.prng_key(0), rng.chrom_hash("_"))   # run_css's default
    for a, b in ((70, 58), (110, 90)):
        pos, am, bm = make_chromosome(10_000, 500_000, a, b, 11)
        plan = plan_windows(pos, 500_000, 2500, 500)
        ids = np.nonzero(plan.valid_mask() & (plan.npos > 0))[0]
        lo, npos, slot = (torch.from_numpy(v[ids].copy()) for v in (plan.lo, plan.npos,
                                                                    plan.slot))
        vals = SnpPair(pos, am, bm).to_device(dev)
        d = kcss.dissimilarity_plain(vals, lo, npos).float().contiguous()
        npos_d, slot_d = npos.to(dev), slot.to(dev)
        for mds in (1, 2):
            ks, _, kv, kr, kn = kcss.css_smacof(d, npos_d, a, b, mds, key, slot_d)
            ps, _, pv, pr, pn = kcss.css_smacof_plain(d, npos_d, a, b, mds, key, slot_d)
            if not (torch.equal(kv, pv) and torch.equal(ks.isnan(), ps.isnan())):
                raise RuntimeError(f"{a}+{b} mode {mds}: valid flags or NaNs differ")
            sel = pv & ~ps.isnan()
            rel = ((ks.double() - ps.double()).abs() / ps.double().abs().clamp(min=1.0))
            differ = ~((kr == pr) & (kn == pn))
            B = d.shape[0]
            print(f"{a}+{b} mode {mds} fast ({kcss.smacof_form(a + b, mds, torch.float32)}): "
                  f"all {B} windows {stats(rel[sel])}, {int(differ[sel].sum())} stop "
                  f"differently; the first {FIRST} {stats(rel[:FIRST][sel[:FIRST]])}, "
                  f"{int(differ[:FIRST][sel[:FIRST]].sum())} stop differently", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(ap.parse_args().tree.resolve()))
    main()
