"""LBVH construction: Morton codes -> sort -> Karras linking -> refit ->
stackless skip-link threading (counterpart of
`raytracercuda_tpu/accel/bvh.py`).

The build is plain PyTorch on whatever device the tensors are on, as the
JAX package's is XLA: a sort, three radix-4 searches, a sparse-table
range min/max for the node boxes and two scatter-max passes for the skip
links.  Its output equals the JAX package's field for field: the same
Morton order, links, leaf ranges and bit-identical node boxes.

Codes and index tables are int64 (the port's index type) where the JAX
package uses uint32 and int32; the values are the same.  `packed_links`
stays int32, the layout kernel K and L read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import BvhConfig
from ..utils.profiler import span


#: Leaf ranges pack into one int32 as ``first * LEAF_PACK + count``;
#: bounds max_leaf_faces and keeps first < 2^25 faces addressable.
LEAF_PACK = 64


class Bvh(NamedTuple):
    """Flattened, threaded BVH (the JAX package's `Bvh`, field for field).

    Nodes: ``N = 2*F - 1`` (internal 0..F-2, Karras leaves F-1..2F-2);
    node 0 is the root (for F == 1 there is a single leaf node).

    Traversal contract: at node ``v`` test the box; on a miss go to
    ``skip_link[v]``; on a hit go to ``hit_link[v]`` if internal, else
    intersect slots ``leaf_first[v] : leaf_first[v] + leaf_count[v]`` and
    then go to ``skip_link[v]``.  ``-1`` terminates.

    ``packed_nodes [N,6]`` float32 box min | max; ``packed_links [N,2]``
    int32: [0] >= 0 the hit link of an internal node, < 0 a leaf's
    ``-(first*LEAF_PACK + count) - 2``; [1] the skip link.
    ``packed_tris [F+LEAF_PACK,9]`` float32: the corners of face
    ``face_order[s]`` in row ``s``, then zero rows.
    """

    node_min: torch.Tensor  # [N,3] float32
    node_max: torch.Tensor  # [N,3] float32
    hit_link: torch.Tensor  # [N] int64: internal -> left child
    skip_link: torch.Tensor  # [N] int64: next node after the subtree, -1 done
    is_leaf: torch.Tensor  # [N] bool (after collapse)
    leaf_first: torch.Tensor  # [N] int64 slot of the first face
    leaf_count: torch.Tensor  # [N] int64
    face_order: torch.Tensor  # [F] int64 face ids in Morton order
    packed_nodes: torch.Tensor  # [N,6] float32 box min|max
    packed_links: torch.Tensor  # [N,2] int32 a-link | skip link
    packed_tris: torch.Tensor  # [F+LEAF_PACK,9] float32 sorted v0|v1|v2

    @property
    def num_faces(self) -> int:
        return self.face_order.shape[0]


def _fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``: NaN propagates, and -0.0 is below +0.0 (torch's
    `minimum` returns its first operand on the tie)."""
    take_a = torch.isnan(a) | (a < b) | ((a == b) & torch.signbit(a))
    return torch.where(take_a, a, b)


def _fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``, as `_fmin`."""
    take_a = torch.isnan(a) | (a > b) | ((a == b) & ~torch.signbit(a))
    return torch.where(take_a, a, b)


def _pack_layouts(node_min, node_max, hit_link, skip_link, is_leaf,
                  leaf_first, leaf_count, face_order, v0, v1, v2):
    """Assemble the packed node / link / triangle layouts."""
    a_link = torch.where(is_leaf, -(leaf_first * LEAF_PACK + leaf_count) - 2,
                         hit_link)
    packed_nodes = torch.cat([node_min, node_max], dim=1).contiguous()
    packed_links = torch.stack([a_link, skip_link], dim=1).to(
        torch.int32).contiguous()
    # LEAF_PACK zero rows of tail padding: a whole leaf's rows are always
    # in range (zero rows are degenerate triangles, which miss).
    packed_tris = torch.cat(
        [v0[face_order], v1[face_order], v2[face_order]], dim=1)
    packed_tris = torch.cat(
        [packed_tris, packed_tris.new_zeros((LEAF_PACK, 9))], dim=0)
    return packed_nodes, packed_links, packed_tris.contiguous()


# ---------------------------------------------------------------------------
# Morton codes.
# ---------------------------------------------------------------------------

def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x two apart (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(q: torch.Tensor) -> torch.Tensor:
    """``[...,3]`` int64 (10-bit) -> 30-bit Morton codes."""
    return ((_part1by2(q[..., 0]) << 2) | (_part1by2(q[..., 1]) << 1)
            | _part1by2(q[..., 2]))


def morton_codes(centroids: torch.Tensor, smin: torch.Tensor,
                 smax: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Quantize centroids into the scene AABB and interleave: the same
    ``((c - smin) / extent) * scale``, clip, truncate as the JAX package."""
    scale = (1 << bits) - 1
    extent = torch.clamp(smax - smin, min=1e-12)
    q = torch.clamp((centroids - smin) / extent * scale, 0, scale)
    return morton3d(q.to(torch.int64))


# ---------------------------------------------------------------------------
# Karras 2012 internal-node construction, vectorized.
# ---------------------------------------------------------------------------

def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the low 32 bits of int64 ``x`` (32 for 0): an exact
    binary search over shifts, no float ``log2``."""
    x = x & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_clear = (x >> (32 - s)) == 0
        n = n + torch.where(top_clear, s, 0)
        x = torch.where(top_clear, (x << s) & 0xFFFFFFFF, x)
    return n + (x == 0).to(x.dtype)


def _karras_ranges(codes: torch.Tensor):
    """For each internal node i in [0, n-2], its sorted-leaf range
    ``[first, last]`` and split position gamma, by the longest-common-
    prefix metric; equal codes fall back to the index bits (Karras's
    augmented key).  The searches are radix-4: ``ceil(log2(n) / 2)``
    rounds of three probes each."""
    n = codes.shape[0]
    dev = codes.device
    log2n = max(1, (n - 1).bit_length())
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    ci_all = codes[: n - 1]

    def delta(j):
        """LCP of sorted keys i and j (any leading shape); -1 outside
        [0, n)."""
        valid = (j >= 0) & (j < n)
        cj = codes[j.clamp(0, n - 1)]
        x = ci_all ^ cj
        d = torch.where(x == 0, 32 + _clz32(i ^ j), _clz32(x))
        return torch.where(valid, d, -1)

    d = torch.sign(delta(i + 1) - delta(i - 1))
    dmin = delta(i - d)

    def radix4_max_prefix(threshold):
        """Largest l in [0, B) with delta(i, i + l*d) > threshold (LCP
        against i is monotone non-increasing with distance)."""
        m = (log2n + 1) // 2
        b = (1 << (2 * m)) >> 2
        l = torch.zeros_like(i)
        while b >= 1:
            probes = torch.stack([l + b, l + 2 * b, l + 3 * b])  # [3, n-1]
            dd = delta(i + probes * d) > threshold
            step = torch.where(dd[2], 3, torch.where(
                dd[1], 2, torch.where(dd[0], 1, 0)))
            l = l + b * step
            b >>= 2
        return l

    l = radix4_max_prefix(dmin)
    j = i + l * d
    dnode = delta(j)
    s = radix4_max_prefix(dnode)
    gamma = i + s * d + torch.clamp(d, max=0)
    return torch.minimum(i, j), torch.maximum(i, j), gamma


# ---------------------------------------------------------------------------
# Build.
# ---------------------------------------------------------------------------

def build_bvh(positions: torch.Tensor, faces: torch.Tensor,
              cfg: BvhConfig = BvhConfig()) -> Bvh:
    """The threaded LBVH of a flattened scene, on its tensors' device.

    Args:
      positions: ``[V,3]`` float32 vertex positions.
      faces: ``[F,4]`` face table (3 vertex ids + mesh id).
      cfg: build knobs.

    Span ``accel.build``.
    """
    with span("accel.build"):
        if cfg.max_leaf_faces >= LEAF_PACK:
            raise ValueError(f"max_leaf_faces {cfg.max_leaf_faces} must be "
                             f"below LEAF_PACK ({LEAF_PACK})")
        positions = positions.to(torch.float32)
        num_faces = faces.shape[0]
        dev = positions.device
        corners = positions[faces[:, :3].reshape(-1).long()].reshape(
            num_faces, 3, 3)
        v0, v1, v2 = corners[:, 0], corners[:, 1], corners[:, 2]
        tri_min = _fmin(v0, _fmin(v1, v2))
        tri_max = _fmax(v0, _fmax(v1, v2))
        centroids = (tri_min + tri_max) * 0.5
        # The quantization below maps a signed zero bound to the same code
        # either way, so torch's own reductions serve here.
        smin = tri_min.amin(dim=0)
        smax = tri_max.amax(dim=0)

        codes = morton_codes(centroids, smin, smax, cfg.morton_bits)
        codes, order = torch.sort(codes, stable=True)

        def ints(*vals):
            return torch.tensor(vals, dtype=torch.int64, device=dev)

        if num_faces == 1:
            one = dict(node_min=tri_min, node_max=tri_max,
                       hit_link=ints(-1), skip_link=ints(-1),
                       is_leaf=torch.ones(1, dtype=torch.bool, device=dev),
                       leaf_first=ints(0), leaf_count=ints(1),
                       face_order=order)
            packed = _pack_layouts(*one.values(), v0, v1, v2)
            return Bvh(**one, packed_nodes=packed[0], packed_links=packed[1],
                       packed_tris=packed[2])

        n = num_faces
        num_nodes = 2 * n - 1
        leaf_base = n - 1  # leaf j lives at node leaf_base + j

        first, last, gamma = _karras_ranges(codes)
        left = torch.where(first == gamma, leaf_base + gamma, gamma)
        right = torch.where(last == gamma + 1, leaf_base + gamma + 1,
                            gamma + 1)

        # Parent pointers (each node has exactly one parent).
        internal_ids = torch.arange(n - 1, dtype=torch.int64, device=dev)
        parent = torch.full((num_nodes,), -1, dtype=torch.int64, device=dev)
        parent[left] = internal_ids
        parent[right] = internal_ids

        # Per-node sorted-face ranges.
        leaf_ids = torch.arange(n, dtype=torch.int64, device=dev)
        node_first = torch.cat([first, leaf_ids])
        node_last = torch.cat([last, leaf_ids])
        size = node_last - node_first + 1

        # Boxes as a range min/max query: a node's box is the union of a
        # contiguous run of sorted leaf boxes, answered from a sparse table
        # with two gathers.
        leaf_min = tri_min[order]
        leaf_max = tri_max[order]
        log2n = max(1, (n - 1).bit_length())

        def sparse_table(leaf_vals, combine):
            tbl = [leaf_vals]
            for k in range(1, log2n + 1):
                prev = tbl[-1]
                sh = min(1 << (k - 1), n - 1)
                shifted = torch.cat([prev[sh:], prev[-1:].expand(sh, 3)],
                                    dim=0)
                tbl.append(combine(prev, shifted))
            return torch.stack(tbl)  # [log2n+1, n, 3]

        length = last - first + 1
        klev = 31 - _clz32(length)  # floor(log2(len)) per internal node
        hi_start = last - (torch.ones_like(klev) << klev) + 1

        def rmq(leaf_vals, combine):
            flat = sparse_table(leaf_vals, combine).reshape(-1, 3)
            return combine(flat[klev * n + first], flat[klev * n + hi_start])

        node_min = torch.cat([rmq(leaf_min, _fmin), leaf_min])
        node_max = torch.cat([rmq(leaf_max, _fmax), leaf_max])

        # Leaf collapse: a node becomes a traversal leaf when its subtree is
        # small enough and its parent's is not.
        k = cfg.max_leaf_faces
        parent_size = torch.where(parent >= 0, size[parent.clamp(min=0)],
                                  n + 1)
        is_leaf = (size <= k) & (parent_size > k)

        # Skip links in closed form: the node visited after finishing subtree
        # [a, b] is the largest node whose range starts at b+1; none follows
        # b == n-1.
        node_ids = torch.arange(num_nodes, dtype=torch.int64, device=dev)
        best_size = torch.zeros(n, dtype=torch.int64,
                                device=dev).scatter_reduce(
            0, node_first, size, "amax")
        winner = size == best_size[node_first]
        best_id = torch.full((n,), -1, dtype=torch.int64,
                             device=dev).scatter_reduce(
            0, node_first, torch.where(winner, node_ids, -1), "amax")
        skip_link = torch.where(node_last == n - 1, -1,
                                best_id[torch.clamp(node_last + 1, max=n - 1)])
        hit_link = torch.cat([left, torch.full((n,), -1, dtype=torch.int64,
                                               device=dev)])

        packed_nodes, packed_links, packed_tris = _pack_layouts(
            node_min, node_max, hit_link, skip_link, is_leaf, node_first, size,
            order, v0, v1, v2)
        return Bvh(node_min=node_min, node_max=node_max,
                   hit_link=hit_link, skip_link=skip_link, is_leaf=is_leaf,
                   leaf_first=node_first, leaf_count=size, face_order=order,
                   packed_nodes=packed_nodes, packed_links=packed_links,
                   packed_tris=packed_tris)
