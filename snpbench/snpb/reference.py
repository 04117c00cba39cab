"""The plain reference of ``explore``: the paper's Algorithm 1 in PyTorch.

It imports torch, numpy and the benchmark's own :mod:`.systems`, and
nothing of the program: it works from a :class:`~.systems.PlainSystem`
and an initial configuration, and builds every table it needs itself.

Semantics (the paper's ``C' = C + S·M``, Definition 1, with the rules'
regular expressions as arithmetic progressions):

* rule ``i`` of neuron ``μ`` applies at a configuration ``C`` when
  ``C[μ] >= consume_i`` and ``C[μ]`` is in its language: ``>= base``
  (covering), or ``== base`` (period 0), or ``base + t·period``;
* every neuron with ``k >= 1`` applicable rules fires exactly one; the
  spiking vectors are enumerated in mixed radix with neuron 0 the most
  significant digit: branch ``t`` picks, in neuron ``μ``, the
  ``((t // stride_μ) % k_μ)``-th applicable rule in the system's order,
  ``stride_μ = Π_{j>μ} max(1, k_j)``; ``Ψ = Π_j max(1, k_j)`` branches,
  of which the first ``T`` are taken (``Ψ > T`` is a branch overflow);
  a configuration where no rule applies has no successor;
* the successor is ``C[j] - consume(fired in j) + Σ_{(i, j) synapse}
  produce(fired in i)``.

The BFS: level after level, every frontier row's first ``T`` successors
in (row, branch) order are the candidates; a candidate is new when no
earlier candidate of the level and no archived configuration equals it;
the first ``F`` new ones, in candidate order, are appended to the archive
and form the next frontier (more than ``F`` is a frontier overflow; the
rest are not marked seen).  Levels run while fewer than ``max_steps``
have run and the last one added something.  Past ``V`` archived rows the
archive keeps its first ``V`` (a visited overflow); the reference then
keeps marking the dropped rows seen by their keys alone.

Dedup is exact: each row gets a 64-bit key (a fixed random linear form,
wrapping, then mixed), and every key match is confirmed by comparing the rows
themselves; two different rows with one key raise
:class:`KeyCollision`.  ``key_bits < 64`` with ``verify=False`` is the
control: the same search trusting a narrower key, as a program that
shortened its key would.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .systems import (BASE, CONSUME, COVERING, NEURON, PERIOD, PRODUCE,
                      PlainSystem)

__all__ = ["Reference", "RefResult", "KeyCollision"]

# a block of frontier rows is expanded at once within this many bytes of
# temporaries
_BLOCK_BYTES = 2 << 30
_KEY_SEED = 0x5EED5EED
# murmur3's 64-bit finalizer, on int64 as two's complement
_FMIX = (0xFF51AFD7ED558CCD - (1 << 64), 0xC4CEB9FE1A85EC53 - (1 << 64))
_LOW31 = (1 << 31) - 1


class KeyCollision(RuntimeError):
    """Two different rows share a key (the reference cannot go on)."""


@dataclass
class RefResult:
    configs: torch.Tensor        # (num_discovered, m) int32, discovery order
    num_discovered: int
    steps: int
    branch_overflow: bool
    frontier_overflow: bool
    visited_overflow: bool


class Reference:
    """The reference explorer of one system on one device."""

    def __init__(self, system: PlainSystem, device="cpu", *,
                 key_bits: int = 64, verify: bool = True) -> None:
        if not 1 <= key_bits <= 64:
            raise ValueError(f"key_bits must be in [1, 64], got {key_bits}")
        dev = torch.device(device)
        self.device, self.key_bits, self.verify = dev, key_bits, verify
        m = self.m = system.num_neurons
        r = system.rules[np.argsort(system.rules[:, NEURON], kind="stable")]
        n = self.n = r.shape[0]

        def t(col, dtype=torch.int64):
            return torch.as_tensor(r[:, col], dtype=dtype, device=dev)

        self.rule_neuron = t(NEURON)
        self.consume, self.base = t(CONSUME), t(BASE)
        self.period = t(PERIOD)
        self.covering = t(COVERING).to(torch.bool)
        counts = np.bincount(r[:, NEURON], minlength=m)
        self.R = max(1, int(counts.max()) if n else 1)
        # index n is "no rule": it consumes and produces nothing
        self.consume_ext = torch.cat(
            [t(CONSUME, torch.int32), torch.zeros(1, dtype=torch.int32,
                                                  device=dev)])
        self.produce_ext = torch.cat(
            [t(PRODUCE, torch.int32), torch.zeros(1, dtype=torch.int32,
                                                  device=dev)])
        syn = system.synapses
        self.src = torch.as_tensor(syn[:, 0], dtype=torch.int64, device=dev)
        self.dst = torch.as_tensor(syn[:, 1], dtype=torch.int64, device=dev)
        g = torch.Generator().manual_seed(_KEY_SEED)
        self.key_w = torch.randint(-(1 << 63), (1 << 63) - 1, (m,),
                                   dtype=torch.int64, generator=g).to(dev)

    # -- one step ----------------------------------------------------------

    def successors(self, X: torch.Tensor, T: int):
        """``(cand (B, T, m) int32, valid (B, T), overflow (B,))`` of the
        configurations ``X`` (B, m)."""
        B, m, dev = X.shape[0], self.m, self.device
        s = X.to(torch.int64)[:, self.rule_neuron]                 # (B, n)
        progression = torch.where(
            self.period > 0,
            (s >= self.base)
            & (torch.remainder(s - self.base, self.period.clamp(min=1))
               == 0),
            s == self.base)
        member = torch.where(self.covering, s >= self.base, progression)
        app = member & (s >= self.consume)
        k = torch.zeros((B, m), dtype=torch.int64, device=dev)
        k.index_add_(1, self.rule_neuron, app.to(torch.int64))
        before = (torch.cumsum(k, 1) - k)[:, self.rule_neuron]
        rank = torch.cumsum(app.to(torch.int64), 1) - 1 - before
        R = self.R
        slot = torch.where(app, self.rule_neuron * R + rank, m * R)
        tab = torch.full((B, m * R + 1), self.n, dtype=torch.int64,
                         device=dev)
        tab.scatter_(1, slot, torch.arange(self.n, device=dev).expand(B, -1))
        tab = tab[:, :m * R]
        choices = k.clamp(min=1)
        suffix = torch.cumprod(choices.to(torch.float64).flip(1), 1).flip(1)
        psi = suffix[:, 0]
        stride = torch.cat([suffix[:, 1:], torch.ones_like(suffix[:, :1])],
                           1).clamp(max=2.0 ** 40).to(torch.int64)
        tt = torch.arange(T, device=dev)
        valid = (tt[None, :].to(torch.float64) < psi[:, None]) \
            & app.any(1)[:, None]
        digit = torch.remainder(
            torch.div(tt[None, :, None], stride[:, None, :],
                      rounding_mode="floor"), choices[:, None, :])
        mu = torch.arange(m, device=dev)
        fired = tab.gather(1, (mu * R + digit).reshape(B, T * m)
                           ).reshape(B, T, m)
        delta = -self.consume_ext[fired]
        delta.index_add_(2, self.dst,
                         self.produce_ext[fired].index_select(2, self.src))
        return X[:, None, :] + delta, valid, psi > T

    def keys(self, rows: torch.Tensor) -> torch.Tensor:
        """The rows' keys (K,) int64: a wrapping random linear form, mixed
        by murmur3's finalizer (a bijection, so rows collide exactly when
        their forms do; the mix spreads a form's structure over every
        bit), then its low ``key_bits``."""
        k = (rows.to(torch.int64) * self.key_w).sum(1)
        for c in _FMIX + (None,):
            k = k ^ ((k >> 33) & _LOW31)      # a logical shift by 33
            if c is not None:
                k = k * c
        if self.key_bits < 64:
            k = k & ((1 << self.key_bits) - 1)
        return k

    def _expand(self, frontier: torch.Tensor, T: int):
        """Candidates (B·T, m), validity, keys and branch overflow, in
        blocks of frontier rows."""
        B, m = frontier.shape
        per_row = T * m * 40 + T * self.src.numel() * 4 + self.n * 40
        step = max(1, _BLOCK_BYTES // per_row)
        cand = torch.empty((B * T, m), dtype=torch.int32, device=self.device)
        valid = torch.empty(B * T, dtype=torch.bool, device=self.device)
        keys = torch.empty(B * T, dtype=torch.int64, device=self.device)
        over = torch.zeros((), dtype=torch.bool, device=self.device)
        for i in range(0, B, step):
            c, v, o = self.successors(frontier[i:i + step], T)
            lo, hi = i * T, (i + c.shape[0]) * T
            cand[lo:hi] = c.reshape(-1, m)
            valid[lo:hi] = v.reshape(-1)
            keys[lo:hi] = self.keys(cand[lo:hi])
            over |= o.any()
        return cand, valid, keys, bool(over)

    def _same(self, a: torch.Tensor, b: torch.Tensor) -> None:
        if self.verify and not bool((a == b).all()):
            raise KeyCollision("two different configurations share a key")

    # -- the BFS -----------------------------------------------------------

    def explore(self, init, *, frontier_cap: int, max_branches: int,
                visited_cap: int, max_steps: int) -> RefResult:
        F, T, V = frontier_cap, max_branches, visited_cap
        dev, m = self.device, self.m
        c0 = torch.as_tensor(np.asarray(init), dtype=torch.int32,
                             device=dev).reshape(1, m)
        archive = torch.empty((V, m), dtype=torch.int32, device=dev)
        archive[0] = c0[0]
        n = 1
        vkeys = self.keys(c0)                    # sorted keys of seen rows
        vrow = torch.zeros(1, dtype=torch.int64, device=dev)   # -1: dropped
        frontier = c0
        step, total_new = 0, 1
        b_ovf = f_ovf = v_ovf = False
        while step < max_steps and total_new > 0:
            cand, valid, ck, over = self._expand(frontier, T)
            b_ovf |= over
            # seen before: a key match, confirmed on the archived row
            pos = torch.searchsorted(vkeys, ck).clamp(max=vkeys.numel() - 1)
            found = valid & (vkeys[pos] == ck)
            hit = torch.nonzero(found).squeeze(1)
            rows = vrow[pos[hit]]
            kept = rows >= 0
            self._same(archive[rows[kept]], cand[hit[kept]])
            # first occurrence within the level: a stable sort by key
            cidx = torch.nonzero(valid & ~found).squeeze(1)
            order = torch.sort(ck[cidx], stable=True).indices
            sk = ck[cidx][order]
            dup = torch.zeros_like(sk, dtype=torch.bool)
            dup[1:] = sk[1:] == sk[:-1]
            d = torch.nonzero(dup).squeeze(1)
            self._same(cand[cidx[order[d]]], cand[cidx[order[d - 1]]])
            new = torch.sort(cidx[order[~dup]]).values
            f_ovf |= new.numel() > F
            take = new[:F]
            n_ins = take.numel()
            keep = min(n_ins, V - n)
            v_ovf |= n_ins > keep
            frontier = cand[take]
            archive[n:n + keep] = frontier[:keep]
            ids = torch.full((n_ins,), -1, dtype=torch.int64, device=dev)
            ids[:keep] = torch.arange(n, n + keep, device=dev)
            vkeys, o = torch.sort(torch.cat([vkeys, ck[take]]))
            vrow = torch.cat([vrow, ids])[o]
            n += keep
            step += 1
            total_new = n_ins
        return RefResult(archive[:n], n, step, b_ovf, f_ovf, v_ovf)
