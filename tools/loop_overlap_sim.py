"""How mixed chip_smoke.py phase 8e's neighbourhoods are under L0, per
noise level, simulated on the CPU in the projected space.

Phase 8e draws 262,144 llc_like rows of 1000 classes (class means
|N(0, 1)| on a 10% support mask, plus masked 0.3 |N(0, 1)|) and adds
N(0, spread^2) on every one of the 21,504 dimensions, then mines under a
Gaussian L0 (1000 x 21504, entries N(0, 1/21504)). Under such an L0 the
added noise projects to N(0, spread^2 L0 L0^T), so the rows can be drawn
in the 1000-dim projected space directly: the class means once through
L0, the noise through a Cholesky factor of L0 L0^T (the masked noise's
variance is folded in as isotropic). For each spread it prints the share
of sampled anchors with another class among their 20 nearest rows (the
anchors that can yield a hard negative) and kNN@5 over the same rows.

    python3 tools/loop_overlap_sim.py 1.0 1.1 1.2

Needs about 4 GB of host memory and a few minutes on 8 cores.
"""

import sys

import numpy as np
import torch

D, K, C, PER, ANCHORS, NN = 21504, 1000, 1000, 262, 1024, 20


def main(spreads):
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    n = C * PER
    centers = torch.randn((C, D), generator=g)
    masks = torch.rand((C, D), generator=g) < 0.1
    mu = centers.abs() * masks + 0.3 * np.sqrt(2 / np.pi) * masks
    L0 = torch.randn((K, D), generator=g) / np.sqrt(D)
    m = mu @ L0.T                                   # class means, projected
    del centers, masks, mu
    chol = torch.linalg.cholesky(L0 @ L0.T)
    lab = torch.arange(n) % C
    z = torch.randn((n, K), generator=g) @ chol.T   # N(0, L0 L0^T) rows
    anchors = torch.randperm(n, generator=g)[:ANCHORS]
    masked_var = 0.09 * (1 - 2 / np.pi) * 0.1       # 0.3 |N| on 10% of dims
    for spread in spreads:
        x = m[lab] + np.sqrt(spread ** 2 + masked_var) * z
        xn = (x * x).sum(1)
        mixed = correct = 0
        for c0 in range(0, ANCHORS, 256):
            a = anchors[c0:c0 + 256]
            d = xn[a][:, None] + xn[None] - 2 * x[a] @ x.T
            d[torch.arange(len(a)), a] = float("inf")
            nn = torch.topk(d, NN, largest=False).indices
            mixed += int((lab[nn] != lab[a][:, None]).any(1).sum())
            correct += int((torch.mode(lab[nn[:, :5]], 1).values
                            == lab[a]).sum())
        print(f"spread {spread}: anchors with another class in their "
              f"{NN}-NN {mixed / ANCHORS:.3f}, kNN@5 {correct / ANCHORS:.3f}",
              flush=True)


if __name__ == "__main__":
    main([float(s) for s in sys.argv[1:]] or [1.1])
