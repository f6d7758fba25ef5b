"""What decides ``correct``: each served request, step by step, against
the reference.

The port samples with top-k, by speculative Jacobi decoding. A request's
tokens follow from its prompt, its seed (:mod:`.sampling` draws its noise
again) and, at each decode step, the drafts the step starts from. The
benchmark records, before every step, each slot's length, the number of
drafts it carries and the drafts themselves (``recorder.StepLog``). From
those and the served tokens the check rebuilds each step's window (the
last token, the carried drafts, fresh drafts from the seed's draws or the
grammar's forced tokens) and what the step did: how many tokens it took,
and whether its last one was the window's last sample or a resample after
a rejection.

The reference (float32, TF32 off) then runs once over the prompt and the
served tokens (teacher-forced), and over branches: each step's carried
drafts past the token the previous step rejected, as the previous step saw
them. For the conditional and the unconditional sequence it mixes
``g * (cond - uncond) + uncond``, applies the image grammar and top-k, and
judges every decision of every step:

- each acceptance and the one rejection: ``u < min(1, q(x) / p(x))`` with
  ``q`` the reference's distribution at the draft, ``p`` the reference's
  distribution that the draft was sampled from (1 for a fresh draft); the
  gap is how far ``log u`` lies on the wrong side of ``log min(1, q/p)``;
- each sample (the prefill's token, a full window's last token, each carried
  draft the step reads): Gumbel-max over the reference's top-k with the same
  noise; the gap is how far the served token's score lies below the best;
- each resample after a rejection: Gumbel-max over ``max(0, q - p)``.

A gap is the least change of the reference's log-probabilities that would
make the program's decision the reference's own: a token outside the top-k
has q = 0 until it rises into it. With a float32 program the gaps read 0;
the program's bf16 rounding leaves some above 0. Gaps are in nats, each
capped at ``CAP``. The numbers: the widest gap, the
mean gap over all decisions, the share of samples outside the reference's
top-k, and counts of grammar misses (a forced position without its token,
or a free one outside the image range) and of trajectories that do not add
up (the steps' tokens against the served ones).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .decoder import Decoder
from .grammar import image_range, interval_r, positions_forced
from .sampling import draws

ROWS = 512  # logits rows per block
CAP = 10.0  # nats: a gap wider than this counts as this
RES_EPS = 0.05  # the share of q added to a residual (``_resample``)


def sequences(cfg: dict, item: dict) -> tuple:
    """(cond ids, uncond ids, the prefix length of each) for one request:
    ids are the prefix then the served tokens but the last."""
    gen = list(item["gen"])
    prompt = list(item["prompt"])
    if cfg["serving"]["cfg_mode"] == "mask_prompt":
        unc_prefix = prompt[-1:]
    else:
        unc_prefix = list(item["neg"])
    return prompt + gen[:-1], unc_prefix + gen[:-1], len(prompt), len(unc_prefix)


def trajectory(cfg: dict, mix: dict, item: dict, device) -> dict:
    """Each step's window and what it did, rebuilt from the step records,
    the served tokens and the seed's fresh drafts."""
    W = mix["window"]
    lo, hi = image_range(cfg)
    gen = np.asarray(item["gen"], np.int64)
    P = int(item["prompt_rows"])
    rec = np.asarray(item["steps"], np.int64).reshape(-1, W + 2)
    K = len(rec)
    L = rec[:, 0]
    n = np.append(L[1:], P + len(gen)) - L if K else np.zeros(0, np.int64)
    G = L - P
    ir = interval_r(cfg, mix)
    aw = np.where((G >= 1) & (G < ir), np.clip(ir - G, 1, W), 1)
    forced = positions_forced(cfg, mix, len(gen) + 2 * W + 2)
    _, it = draws(item["seed"], K, W, cfg["vocab_size"], lo, hi, device)
    rand = np.stack([d.rand.cpu().numpy() for d in it]) if K else np.zeros((0, W - 1), np.int64)
    x = np.zeros((K, W), np.int64)
    for k in range(K):
        if n[k] <= 0:
            continue
        x[k, 0] = gen[G[k] - 1]
        for j in range(1, W):
            f = forced[G[k] - 1 + j]
            x[k, j] = (rec[k, 2 + j - 1] if j - 1 < rec[k, 1] else f if f >= 0 else rand[k, j - 1])
    # a request's first step follows its prefill: one token, no drafts carried
    ok = ((K == 0 or (L[0] == P + 1 and rec[0, 1] == 0 and n.min() >= 0))
          and int(n.sum()) == len(gen) - 1)
    return dict(K=K, L=L, n=n, G=G, aw=aw, cc=rec[:, 1], x=x, forced=forced, ok=bool(ok))


def branch_groups(tr: dict) -> Dict[int, list]:
    """Per branch length m: [(step k, tokens [m], first gen index)]: step
    k's carried drafts that it reads, as the previous step saw them."""
    out: Dict[int, list] = {}
    n, aw, cc, x, G = tr["n"], tr["aw"], tr["cc"], tr["x"], tr["G"]
    for k in range(1, tr["K"]):
        if n[k] <= 0 or cc[k] <= 0:
            continue
        J = n[k] if n[k] < aw[k] else aw[k] - 1
        m = int(min(J, cc[k]))
        if m <= 0:
            continue
        out.setdefault(m, []).append((k, x[k - 1, n[k - 1]:n[k - 1] + m], int(G[k] - 1)))
    return out


def image_logq(mixed: torch.Tensor, lo: int, hi: int, k: int) -> tuple:
    """Mixed logits [r, V] -> (log q over the image range [r, Vi], the
    top-k set [r, Vi], log q of the k-th best [r]): q is the softmax over
    the k best image tokens (ties kept); ``log q`` is read outside that set
    too, as the score less the set's log-normaliser."""
    s = mixed[:, lo:hi + 1]
    kth = torch.topk(s, min(k, s.shape[1]), dim=1).values[:, -1:]
    keep = s >= kth
    lse = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=1, keepdim=True)
    return s - lse, keep, (kth - lse)[:, 0]


class Gaps:
    """Gaps of one side's decisions, on the device until read."""

    def __init__(self):
        self.gaps: List[torch.Tensor] = []
        self.outside: List[torch.Tensor] = []
        self.grammar_misses = 0
        self.trajectory_misses = 0
        self.tokens = 0

    def add(self, gap: torch.Tensor):
        self.gaps.append(gap.clamp(0.0, CAP).reshape(()))

    def read(self) -> dict:
        g = torch.stack(self.gaps).double() if self.gaps else torch.zeros(1)
        out_k = torch.stack(self.outside).double() if self.outside else torch.zeros(1)
        bad = self.grammar_misses + self.trajectory_misses
        inf = float("inf")
        return {"logit_gap": inf if bad else float(g.max()),
                "mean_gap": inf if bad else float(g.mean()),
                "outside_topk": inf if bad else float(out_k.mean()),
                "decisions": len(self.gaps), "tokens": self.tokens,
                "grammar_misses": self.grammar_misses,
                "trajectory_misses": self.trajectory_misses}


def _pick(acc: Gaps, logq, keep, kth, g, z: int):
    """A Gumbel-max sample: its gap is the least that the served token's
    score has to rise by to be the best of the top-k, and in it."""
    sc = logq + g
    best = sc.masked_fill(~keep, float("-inf")).max()
    acc.add(torch.maximum(best - sc[z], kth - logq[z]))
    acc.outside.append((~keep[z]).float())


def _resample(acc: Gaps, logq, keep, kth, p, g, z: int):
    """A Gumbel-max resample from the residual ``max(0, q - p)``, which is
    ``q`` itself where it is 0 everywhere. The residual is a difference:
    where ``q`` and ``p`` nearly cancel, rounding moves it by far more than
    it moves either, so the served token's residual is judged with
    ``RES_EPS`` of its ``q`` added; and, as for a sample, the served token
    has to be in the top-k."""
    q_soft = torch.exp(logq)
    q = q_soft * keep
    rho = torch.clamp_min(q - p, 0.0)
    rho = torch.where(rho.max() > 0, rho, q)
    sc = torch.log(rho) + g
    served = torch.log(rho[z] + RES_EPS * q_soft[z]) + g[z]
    acc.add(torch.maximum(sc.max() - served, kth - logq[z]))


def judge(cfg: dict, mix: dict, item: dict, tr: dict, tf: tuple, br: dict, acc: Gaps,
          device) -> None:
    """Every decision of one request: ``tf`` (log q, top-k set) per
    generated position, ``br[k]`` the same for step k's branch rows."""
    lo, hi = image_range(cfg)
    W, V = mix["window"], cfg["vocab_size"]
    gen = np.asarray(item["gen"], np.int64)
    forced = tr["forced"]
    acc.tokens += len(gen)
    if not tr["ok"]:
        acc.trajectory_misses += 1
        return
    logq, keep, kth = tf
    bad = 0
    zero, inf = (torch.tensor(v, device=device) for v in (0.0, float("inf")))

    def free_tok(gi: int, z: int) -> Optional[int]:
        """The image index of ``z`` at a free position, or None where the
        grammar judges it (a miss counted)."""
        nonlocal bad
        if forced[gi] >= 0:
            bad += int(z != forced[gi])
            return None
        if not lo <= z <= hi:
            bad += 1
            return None
        return z - lo

    def log_p(rows, i, gi, z):
        """(log q at token z, how far z lies inside the top-k) of a
        distribution row; a forced row holds its token with certainty."""
        if forced[gi] >= 0 or not lo <= z <= hi:
            hit = forced[gi] >= 0 and z == forced[gi]
            return (zero, inf) if hit else (-inf, -inf)
        lq = rows[0][i, z - lo]
        return lq, lq - rows[2][i]

    def hard(rows, i):
        return torch.exp(rows[0][i]) * rows[1][i]

    g0, steps = draws(item["seed"], tr["K"], W, V, lo, hi, device)
    zi = free_tok(0, int(gen[0]))
    if zi is not None:
        _pick(acc, logq[0], keep[0], kth[0], g0[lo:hi + 1], zi)
    n, aw, cc, x, G = tr["n"], tr["aw"], tr["cc"], tr["x"], tr["G"]
    prev = None
    for k, d in enumerate(steps):
        if n[k] <= 0:
            prev = d
            continue
        Gk, nk = int(G[k]), int(n[k])
        rows = br.get(k)
        J = nk if nk < aw[k] else aw[k] - 1
        for j in range(1, J + 1):
            gi = Gk + j - 1
            xj = int(x[k, j])
            carried = j - 1 < cc[k]
            lq, inside = log_p(tf, gi, gi, xj)
            lp = log_p(rows, j - 1, gi, xj)[0] if carried else zero
            lr = torch.clamp_max(torch.nan_to_num(lq - lp, nan=float("-inf")), 0.0)
            lu = torch.log(d.u[j - 1])
            # the least change of the reference's scores that makes the
            # program's decision right: a draft outside the top-k has q = 0
            if j < nk:  # accepted
                acc.add(torch.maximum(lu - lr, -inside))
            else:  # rejected
                acc.add(torch.minimum(lr - lu, inside))
            if carried:  # the draft as the previous step sampled it
                zi = free_tok(gi, xj)
                if zi is not None:
                    row = int(n[k - 1]) + j - 1
                    _pick(acc, rows[0][j - 1], rows[1][j - 1], rows[2][j - 1],
                          prev.g_tok[row, lo:hi + 1], zi)
        gi = Gk + nk - 1
        zi = free_tok(gi, int(gen[gi]))
        if zi is not None:
            if nk == aw[k]:
                _pick(acc, logq[gi], keep[gi], kth[gi], d.g_tok[nk - 1, lo:hi + 1], zi)
            else:
                xr = int(x[k, nk])
                if nk - 1 < cc[k]:
                    p = hard(rows, nk - 1)
                else:
                    p = torch.zeros(hi - lo + 1, device=device)
                    if lo <= xr <= hi:
                        p[xr - lo] = 1.0
                _resample(acc, logq[gi], keep[gi], kth[gi], p, d.g_res[lo:hi + 1], zi)
        prev = d
    acc.grammar_misses += bad


def check_tokens(cfg: dict, mix: dict, device, items: Sequence[dict]) -> dict:
    """The served requests ``items`` (prompt, neg, gen, seed, prompt_rows,
    steps) judged step by step against the reference."""
    lo, hi = image_range(cfg)
    g, k_img = mix["guidance_scale"], mix["image_top_k"]
    dec = Decoder(cfg, device)
    trs = [trajectory(cfg, mix, it, device) for it in items]
    seqs, branches, meta = [], {}, []
    for it, tr in zip(items, trs):
        c, u, pc, pu = sequences(cfg, it)
        i = len(seqs)
        for ids in (c, u):
            seqs.append((torch.tensor(ids), torch.arange(len(ids))))
        groups = branch_groups(tr) if tr["ok"] else {}
        order = sorted(groups)
        for side, pre in ((i, pc), (i + 1, pu)):
            branches[side] = [(torch.as_tensor(np.stack([t for _, t, _ in groups[m]])),
                               torch.as_tensor([pre + s for _, _, s in groups[m]]))
                              for m in order]
        meta.append((i, pc, pu, [(m, [kk for kk, _, _ in groups[m]]) for m in order]))
    hid, bhid = dec.hidden(seqs, branches)
    acc = Gaps()
    for it, tr, (i, pc, pu, gmeta) in zip(items, trs, meta):
        Gn = len(it["gen"])
        hc, hu = hid[i][pc - 1:pc - 1 + Gn], hid[i + 1][pu - 1:pu - 1 + Gn]
        parts = [image_logq(g * (lc - lu) + lu, lo, hi, k_img)
                 for lc, lu in ((dec.logits(hc[a:a + ROWS]), dec.logits(hu[a:a + ROWS]))
                                for a in range(0, Gn, ROWS))]
        tf = tuple(torch.cat([p[i] for p in parts]) for i in range(3))
        br = {}
        for gid, (m, ks) in enumerate(gmeta):
            bc, bu = bhid[i][gid], bhid[i + 1][gid]
            lc, lu = dec.logits(bc.reshape(-1, bc.shape[-1])), dec.logits(bu.reshape(-1, bu.shape[-1]))
            rows = image_logq(g * (lc - lu) + lu, lo, hi, k_img)
            for r, kk in enumerate(ks):
                br[kk] = tuple(t[r * m:(r + 1) * m] for t in rows)
        judge(cfg, mix, it, tr, tf, br, acc, device)
        del tf, br
    dec.release()
    return acc.read()
