"""The comparisons that decide ``correct``: what the timed path produced,
judged by the reference.

Tokens are judged by what they say, not by equality: with random weights
the fifth nearest codeword changes on rounding, so a token is held to the
reference's distances. A code's gap is how far the farthest of its chosen
codewords lies beyond the reference's k-th nearest (0 when every chosen
codeword is among the reference's k nearest). Weights and embeddings are
then held to what the reference computes for the tokens the program chose.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.medtok import PATHS, MedTok


#: the gap of a token outside its region: the widest distance of unit rows
OUTSIDE_GAP = 4.0


def token_gap(ref: MedTok, z_n: torch.Tensor, tokens: torch.Tensor, region: str) -> torch.Tensor:
    """Per row: max over the chosen tokens of the reference distance, less
    the reference's k-th smallest distance (region-local token ids; a row
    with a token outside the region reads ``OUTSIDE_GAP``)."""
    lo, hi = ref.regions()[region]
    d = ref.distances(z_n, ref.codebook_n()[lo:hi])
    tokens = tokens.long()
    k = tokens.shape[1]
    kth = torch.topk(d, k, dim=1, largest=False).values[:, -1]
    inside = ((tokens >= 0) & (tokens < hi - lo)).all(1)
    gap = (d.gather(1, tokens.clamp(0, hi - lo - 1)).amax(1) - kth).clamp(min=0.0)
    return torch.where(inside, gap, OUTSIDE_GAP)


@torch.no_grad()
def judge_export(ref: MedTok, rows: dict, tokens, weights, embedding) -> dict[str, float]:
    """``token_gap``: the widest gap over the codes and the four paths;
    ``weight_err``: the largest difference of a weight from softmax(-d) of
    the reference's distances to the chosen codewords; ``embedding_err``:
    the largest relative L2 error of an embedding part against the
    reference's weighted sum of the chosen codewords."""
    dev = next(iter(rows.values())).device

    def on(x, dtype):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        return x.to(dev, dtype)

    tokens, weights, embedding = on(tokens, torch.long), on(weights, torch.float32), \
        on(embedding, torch.float32)
    D = rows[PATHS[0]].shape[1]
    e_n = ref.codebook_n()
    gap = werr = eerr = 0.0
    for p, path in enumerate(PATHS):
        lo, hi = ref.regions()[path]
        e_r = e_n[lo:hi]
        gap = max(gap, float(token_gap(ref, rows[path], tokens[:, p], path).max()))
        t = tokens[:, p].clamp(0, hi - lo - 1)
        d = ref.distances(rows[path], e_r).gather(1, t)
        w_ref = torch.softmax(-d, dim=-1)
        werr = max(werr, float((weights[:, p] - w_ref).abs().max()))
        zq = (w_ref[..., None] * e_r[t]).sum(1)
        part = embedding[:, p * D:(p + 1) * D]
        rel = torch.linalg.vector_norm(part - zq, dim=1) / torch.linalg.vector_norm(zq, dim=1)
        eerr = max(eerr, float(rel.max()))
    return {"token_gap": gap, "weight_err": werr, "embedding_err": eerr}


def leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's |norm(got) - norm(want)|, against the larger of
    that leaf's reference norm and the median leaf's; leaves outside
    ``keep`` are left out."""
    names = [n for n in want if keep is None or n in keep]
    ref = {n: float(torch.linalg.vector_norm(want[n].float())) for n in names}
    med = float(np.median(list(ref.values())))
    worst = 0.0
    for n in names:
        g = float(torch.linalg.vector_norm(got[n].float()))
        worst = max(worst, abs(g - ref[n]) / max(ref[n], med))
    return worst
