"""The Brownian Interval and the host Virtual Brownian Tree (port of
:mod:`repro.core.brownian_interval`; paper §4, App. E).

The tree, the LRU cache keyed by node, the search hints, the trampolined
traversal (Algorithm 4), the pre-planted dyadic tree and both ``levy_area``
modes are the reference's, on the host.  Each node's normals come from
numpy's ``Philox(key=seed)`` exactly as there, drawn on the host and copied
to the sampler's device in one transfer a sampled node
(:attr:`BrownianInterval.transfers` counts them); the cached increments and
every query's result are torch tensors there (the card by default), and the
bridge arithmetic runs on them as separate elementwise ops, each rounding
once — so in float64 the results are the reference's bits, on the CPU and
on the card.  A division of a tensor by a host scalar is written as a
division by a 0-d tensor on the device: on the card ``tensor / python_float``
multiplies by the reciprocal, which is not numpy's division.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ref import true_divide
from .solvers import NP_DTYPES

__all__ = ["BrownianInterval", "HostVirtualBrownianTree"]


class _Node:
    __slots__ = ("a", "b", "seed", "parent", "left", "right")

    def __init__(self, a: float, b: float, seed: int, parent: Optional["_Node"]):
        self.a = a
        self.b = b
        self.seed = seed
        self.parent = parent
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None


def _split_seed(seed: int) -> Tuple[int, int]:
    """The children's seeds: a counter-based hash of the parent's (numpy's
    Philox), the reference's."""
    rng = np.random.Philox(key=seed & ((1 << 64) - 1))
    child = np.random.Generator(rng).integers(0, 2**63 - 1, size=2)
    return int(child[0]), int(child[1])


def _gen(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed & ((1 << 64) - 1)))


class _LRU:
    """Fixed-size LRU cache: node id -> increment (a tensor or a pair)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, k: int):
        v = self._d.get(k)
        if v is not None:
            self.hits += 1
            self._d.move_to_end(k)
        else:
            self.misses += 1
        return v

    def put(self, k: int, v) -> None:
        self._d[k] = v
        self._d.move_to_end(k)
        if len(self._d) > self.maxsize:
            self._d.popitem(last=False)


def _dtype(dtype) -> torch.dtype:
    """A torch float dtype from a torch or numpy one (the reference takes
    ``np.float64``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


class BrownianInterval:
    """Exact sampling and reconstruction of Brownian increments ``W_{s,t}``.

    ``t0, t1``: the interval; ``shape``: each increment's; ``seed``: the
    root of the splittable seed tree; ``cache_size``: LRU entries;
    ``preplant_dt``: pre-plant a dyadic tree with leaves no larger than
    ``0.8·preplant_dt·cache_size`` (right-to-left sweeps O(n log n));
    ``levy_area``: ``None`` or ``"space-time"`` (queries return ``(W, H)``,
    each node carrying its raw time-area ``A = ∫(W_r − W_a) dr``);
    ``device``: where the increments live (the card unless ``"cpu"``).
    """

    def __init__(self, t0: float, t1: float, shape: Tuple[int, ...], seed: int = 0,
                 cache_size: int = 128, preplant_dt: Optional[float] = None,
                 dtype=torch.float64, levy_area: Optional[str] = None, device=None):
        assert t1 > t0
        if levy_area not in (None, "space-time"):
            raise ValueError(f"unknown levy_area mode {levy_area!r}; supported: "
                             f"(None, 'space-time')")
        self.t0, self.t1 = float(t0), float(t1)
        self.shape = tuple(shape)
        self.dtype = _dtype(dtype)
        self.device = resolve_device(device)
        self.levy_area = levy_area
        #: host-to-device copies made, one a sampled node
        self.transfers = 0
        self._root = _Node(self.t0, self.t1, seed, None)
        self._cache = _LRU(cache_size)
        self._hint: _Node = self._root
        if preplant_dt is not None:
            leaf = max(preplant_dt * cache_size * 0.8, 1e-12)
            self._preplant(self._root, leaf)

    # -- public API ----------------------------------------------------------
    def __call__(self, s: float, t: float):
        """Exact ``W_t − W_s``, or the ``(W, H)`` pair in space-time mode."""
        if not (self.t0 <= s < t <= self.t1):
            raise ValueError(f"query [{s}, {t}] outside [{self.t0}, {self.t1}]")
        nodes = self._traverse(self._hint, s, t)
        self._hint = nodes[-1]
        if self.levy_area == "space-time":
            w_acc = self._zeros()
            a_acc = self._zeros()
            for n in nodes:
                w_i, a_i = self._sample(n)
                a_acc += a_i + (n.b - n.a) * w_acc
                w_acc += w_i
            return w_acc, true_divide(a_acc, t - s) - 0.5 * w_acc
        out = self._zeros()
        for n in nodes:
            out += self._sample(n)
        return out

    @property
    def cache_stats(self) -> Tuple[int, int]:
        return self._cache.hits, self._cache.misses

    # -- tensors on the device -------------------------------------------------
    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)

    def _upload(self, *arrays: np.ndarray):
        """The node's host draws on the device in one copy; one tensor each."""
        host = np.stack([a.astype(NP_DTYPES[self.dtype], copy=False) for a in arrays])
        self.transfers += 1
        dev = torch.from_numpy(host).to(self.device)
        return tuple(dev[i] for i in range(len(arrays)))

    # -- Algorithm 3: sample ---------------------------------------------------
    def _base_normal(self, seed: int, scale: float) -> torch.Tensor:
        return self._upload(_gen(seed).normal(0.0, scale, size=self.shape))[0]

    def _bridge(self, a: float, b: float, x: float, w_parent: torch.Tensor,
                seed: int) -> torch.Tensor:
        """Lévy bridge (paper eq. (8)): ``W_{a,x} | W_{a,b} = w_parent``."""
        mean = (x - a) / (b - a) * w_parent
        std = np.sqrt((b - x) * (x - a) / (b - a))
        (z,) = self._upload(_gen(seed).standard_normal(self.shape))
        return mean + float(std) * z

    def _root_pair(self, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Unconditional ``(W, A)`` over the whole interval: ``W ~ N(0, h)``,
        ``H ~ N(0, h/12)``, ``A = h(H + W/2)``."""
        h = self.t1 - self.t0
        g = _gen(seed)
        w_host = g.normal(0.0, np.sqrt(h), size=self.shape)
        hh_host = g.normal(0.0, np.sqrt(h / 12.0), size=self.shape)
        w, hh = self._upload(w_host, hh_host)
        return w, h * (hh + 0.5 * w)

    def _bridge_pair(self, a: float, b: float, x: float,
                     parent: Tuple[torch.Tensor, torch.Tensor],
                     seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Left-child ``(w₁, A₁)`` over ``[a, x]`` given the parent pair over
        ``[a, b]``: exact Gaussian conditioning at ``θ = (x−a)/(b−a)``, ``A₁``
        conditional on the realised ``w₁`` (the reference's formulas)."""
        w, area = parent
        h = b - a
        th = (x - a) / h
        g = _gen(seed)
        xi0_host = g.standard_normal(self.shape)
        xi1_host = g.standard_normal(self.shape)
        xi0, xi1 = self._upload(xi0_host, xi1_host)
        mean_w = (3.0 * th * th - 2.0 * th) * w + true_divide(6.0 * th * (1.0 - th) * area, h)
        var_w = h * th * (1.0 - 4.0 * th + 6.0 * th * th - 3.0 * th ** 3)
        var_w = max(var_w, 0.0)
        w1 = mean_w + float(np.sqrt(var_w)) * xi0
        mean_a = -h * th * th * (1.0 - th) * w + (3.0 * th * th - 2.0 * th ** 3) * area
        var_a = (h ** 3 / 3.0) * th ** 3 * (1.0 - th) ** 3
        cov = 0.5 * h * h * th * th * (1.0 - th) ** 2 * (1.0 - 2.0 * th)
        if var_w > 0.0:
            mean_a = mean_a + (cov / var_w) * (w1 - mean_w)
            var_a = var_a - cov * cov / var_w
        a1 = mean_a + float(np.sqrt(max(var_a, 0.0))) * xi1
        return w1, a1

    def _sample(self, node: _Node):
        cached = self._cache.get(id(node))
        if cached is not None:
            return cached
        pairs = self.levy_area == "space-time"
        if node is self._root:
            out = (self._root_pair(node.seed) if pairs else
                   self._base_normal(node.seed, np.sqrt(self.t1 - self.t0)))
        else:
            parent = node.parent
            w_parent = self._sample(parent)
            left = parent.left
            if pairs:
                w1, a1 = self._bridge_pair(parent.a, parent.b, left.b, w_parent, left.seed)
                if node is parent.right:
                    # complement: W₂ = W − w₁; A₂ = A − A₁ − (b − x)·w₁
                    wp, ap = w_parent
                    out = (wp - w1, ap - a1 - (parent.b - left.b) * w1)
                else:
                    out = (w1, a1)
            elif node is parent.right:
                # W_{mid, b} = W_{a, b} − W_{a, mid}
                w_left = self._bridge(parent.a, parent.b, left.b, w_parent, left.seed)
                out = w_parent - w_left
            else:
                out = self._bridge(parent.a, parent.b, node.b, w_parent, node.seed)
        self._cache.put(id(node), out)
        return out

    # -- Algorithm 4: traverse -------------------------------------------------
    def _bisect(self, node: _Node, x: float) -> None:
        s_left, s_right = _split_seed(node.seed)
        node.left = _Node(node.a, x, s_left, node)
        node.right = _Node(x, node.b, s_right, node)

    def _traverse(self, start: _Node, c: float, d: float) -> List[_Node]:
        nodes: List[_Node] = []
        # trampolined Algorithm 4 (recursion overflows otherwise, App. E)
        stack: List[Tuple[_Node, float, float]] = [(start, c, d)]
        while stack:
            node, lo, hi = stack.pop()
            while lo < node.a or hi > node.b:  # outside the node: to its parent
                node = node.parent
            if lo == node.a and hi == node.b:
                nodes.append(node)
                continue
            if node.left is None:  # leaf
                if node.a == lo:
                    self._bisect(node, hi)
                    nodes.append(node.left)
                else:
                    self._bisect(node, lo)
                    stack.append((node.right, lo, hi))
                continue
            m = node.left.b
            if hi <= m:
                stack.append((node.left, lo, hi))
            elif lo >= m:
                stack.append((node.right, lo, hi))
            else:  # across both children, left to right
                stack.append((node.right, m, hi))
                stack.append((node.left, lo, m))
        return nodes

    def _preplant(self, node: _Node, leaf_size: float) -> None:
        stack = [node]
        while stack:
            n = stack.pop()
            if (n.b - n.a) <= leaf_size:
                continue
            self._bisect(n, 0.5 * (n.a + n.b))
            stack.extend((n.left, n.right))


class HostVirtualBrownianTree:
    """The Li et al. baseline on the host's seed tree: every query descends
    from the root to resolution ``eps`` — no cache, no tree growth.  The
    levels' normals of one query are drawn on the host and copied to the
    device at once; the descent's arithmetic runs there."""

    def __init__(self, t0: float, t1: float, shape, seed: int = 0, eps: float = 1e-5,
                 dtype=torch.float64, device=None):
        self.t0, self.t1 = float(t0), float(t1)
        self.shape = tuple(shape)
        self.eps = eps
        self.seed = seed
        self.dtype = _dtype(dtype)
        self.device = resolve_device(device)
        #: host-to-device copies made, one a point query
        self.transfers = 0
        self._depth = max(1, int(math.ceil(math.log2((t1 - t0) / eps))))

    def _w(self, t: float) -> torch.Tensor:
        np_dtype = NP_DTYPES[self.dtype]
        draws = [np.random.Generator(np.random.Philox(key=self.seed))
                 .standard_normal(self.shape).astype(np_dtype)]
        walk = []  # (std, go_left) a level
        a, b = self.t0, self.t1
        seed = self.seed
        for _ in range(self._depth):
            m = 0.5 * (a + b)
            s_left, s_right = _split_seed(seed)
            gm = np.random.Generator(np.random.Philox(key=s_left))
            draws.append(gm.standard_normal(self.shape).astype(np_dtype))
            walk.append((np.sqrt((b - m) * (m - a) / (b - a)), t <= m))
            if t <= m:
                b, seed = m, s_left
            else:
                a, seed = m, s_right
            if (b - a) <= self.eps:
                break
        z = torch.from_numpy(np.stack(draws)).to(self.device)
        self.transfers += 1
        w_a = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        w_b = z[0] * float(np.sqrt(self.t1 - self.t0))
        for k, (std, go_left) in enumerate(walk):
            w_m = 0.5 * (w_a + w_b) + float(std) * z[k + 1]
            if go_left:
                w_b = w_m
            else:
                w_a = w_m
        return w_a

    def __call__(self, s: float, t: float) -> torch.Tensor:
        return self._w(t) - self._w(s)
