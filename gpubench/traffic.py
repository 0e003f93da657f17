"""The one traffic generator: chromosomes of a two-population SNP panel
from a mix's parameters (``gpubench/traffic/<name>.json``) and the
configuration's panel and SNP density, made from ``--seed``.

After ``divergence_tpu_torch/tools/synth.py`` (``make_chromosome``, the
bench's generator, and ``make_panel``): sorted distinct positions in [1,
bp), Hardy-Weinberg genotypes from a per-SNP major-allele frequency drawn
from U(0.2, 0.9), a share of missing calls.  Divergence is a share of the
chromosome's base pairs laid out as islands of ``island_bp`` (one at a
random place in each of as many equal stretches): inside an island the two
populations draw their frequencies apart, outside they share one.  A share
of 1 makes every SNP divergent (``make_chromosome``), 0 none.

Every seed gives the same sizes (SNPs, islands and their lengths) in other
places.  The draws run on ``device`` in a few large calls with a
``torch.Generator`` there, so one seed gives one panel on a given kind of
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CODE_MAJOR, CODE_HET, CODE_MINOR, CODE_MISSING = 3, 0, -3, -10000


@dataclasses.dataclass
class Chromosome:
    seqid: str
    bp: int
    positions: np.ndarray   # [N] int64
    avals: np.ndarray       # [N, asize] int16 genotype codes
    bvals: np.ndarray       # [N, bsize] int16


def _generator(seed: int, index: int, device) -> torch.Generator:
    words = np.random.SeedSequence([int(seed) % (1 << 64), index]).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return g


def _genotypes(p: torch.Tensor, size: int, missing: float, g: torch.Generator) -> torch.Tensor:
    u = torch.rand((p.shape[0], size), generator=g, device=p.device)
    p = p[:, None]
    het = 2.0 * p * (1.0 - p)
    codes = torch.where(u < p * p, CODE_MAJOR,
                        torch.where(u < p * p + het, CODE_HET, CODE_MINOR))
    miss = torch.rand((p.shape[0], size), generator=g, device=p.device) < missing
    return torch.where(miss, CODE_MISSING, codes).to(torch.int16)


def chromosome(config: dict, traffic: dict, seed: int, index: int, device) -> Chromosome:
    """Chromosome ``index`` of the mix under ``seed``."""
    g = _generator(seed, index, device)
    bp = int(traffic["bp"])
    npos = int(round(bp * config["snps_per_kb"] / 1000))
    cand = torch.unique(torch.randint(1, bp, (int(npos * 1.25) + 64,), generator=g,
                                      device=device))
    if cand.numel() < npos:
        raise ValueError(f"{bp} bp hold fewer than {npos} distinct positions")
    keep = torch.sort(torch.randperm(cand.numel(), generator=g, device=device)[:npos]).values
    pos = cand[keep]

    share = float(traffic["divergent_bp_share"])
    if share >= 1.0:
        divergent = torch.ones(npos, dtype=torch.bool, device=device)
    elif share <= 0.0:
        divergent = torch.zeros(npos, dtype=torch.bool, device=device)
    else:
        isl = int(traffic["island_bp"])
        n_isl = max(1, round(share * bp / isl))
        seg = bp // n_isl
        if seg < isl:
            raise ValueError("islands longer than their stretches")
        starts = (torch.arange(n_isl, device=device) * seg
                  + torch.randint(0, seg - isl + 1, (n_isl,), generator=g, device=device))
        i = torch.searchsorted(starts, pos, right=True) - 1
        divergent = (i >= 0) & (pos < starts[i.clamp(min=0)] + isl)

    pa = 0.2 + 0.7 * torch.rand(npos, generator=g, device=device)
    apart = 0.2 + 0.7 * torch.rand(npos, generator=g, device=device)
    pb = torch.where(divergent, apart, pa)
    miss = float(config["missing_share"])
    a = _genotypes(pa, int(config["asize"]), miss, g)
    b = _genotypes(pb, int(config["bsize"]), miss, g)
    return Chromosome(seqid=f"chr{index + 1}", bp=bp, positions=pos.cpu().numpy().astype(np.int64),
                      avals=a.cpu().numpy(), bvals=b.cpu().numpy())


def chromosomes(config: dict, traffic: dict, seed: int, device) -> list[Chromosome]:
    return [chromosome(config, traffic, seed, i, device) for i in range(int(traffic["chromosomes"]))]
