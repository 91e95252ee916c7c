#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`raytracercuda_torch`) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

  1. requires a CUDA device and prints its name and power limit;
  2. builds the CUDA kernels from `raytracercuda_torch/csrc/` (one nvcc
     per source, in parallel) and prints the build time and each kernel's
     registers per thread (from ptxas);
  3. renders the bench frame once through `FrameRenderer` (512x512, a
     69,451-triangle bumpy sphere with uvs and a texture, shadows on) and
     requires that kernels A and B both launched in that run;
  4. holds kernel A and kernel B against their plain PyTorch versions on
     the card, on the inputs that frame gave them (A: slots equal, t/u/v
     bit-equal, attributes within 1e-5; B: equal masks), with their work
     items, and the eye and light rows their C entries staged bit-equal
     to `_eye_rows_plain` and `_light_rows_plain` (`staged_rows_check`;
     so too C's and H's in phases 10 and 10c); in every phase that counts
     launches, one staged table a launch of A, B, C or H and none of F
     (`staged_counts`);
  5. renders the same frame with the plain versions on the card and
     requires every u8 channel within 1, hit pixels and shadowed pixels;
  6. times 50 frames on each path and each kernel beside its plain
     version;
 6b. holds the frustum and beam cull kernels (`csrc/cull.cu`) against
     their plain chains on the bench frame, and 6c on config 4's first
     progressive pass (built first, as in phase 7) and the three on
     config 5's two-bounce frame (built first, as in phase 17; the
     general cull once a bounce): one launch of each a cull, the frame
     and the pass bit-equal to the chains' route, the masks (the frustum
     and beam culls' in both layouts) differing only where a test is
     within rounding of its threshold (`CULL_THRESHOLD_REL`), the lists
     compared, and each kernel timed beside its chain and its bound;
 6d. holds the frame's two shading kernels (`csrc/frame.cu`:
     `shadow_setup_kernel`, `frame_shade_kernel`) against the plain
     phases of `trace/shade.py` on the bench frame's inputs (n.l, the
     shadow mask, the origins and the framebuffer bit-equal, one launch
     of each, the frame bit-equal to the plain phases' route) and times
     each by CUDA events, with the host hidden and by the profiler,
     beside its chain and a bytes bound at 3.35 TB/s;
  7. builds the config-4 scene at 1024x1024: a 345,944-triangle bumpy
     sphere (the armadillo stand-in) and, standing in for f16.obj, a
     4,056-triangle textured bumpy sphere with a seeded 256x256 texture;
  8. runs `progressive_step` with shadows (warm-up, then three steps) and
     requires that kernels C and H launched;
  9. takes the grad step of `l2_image_loss` over (positions, textures)
     against a zero target and requires finite, nonzero gradients and at
     least two launches of kernel G;
 10. holds C, H and G against their plain versions on the inputs of
     phases 8-9 (C, on the progressive and the grad step's inputs: slots
     equal, t/u/v bit-equal, and its work items, K and active lanes per
     warp printed; H: equal masks, its work items and active lanes per
     warp, and the tests a serial early-exit sweep would run; G: rows no
     ray names exactly 0.0, the
     rest within |k - p| <= 1e-5 max|p| + 1e-6, and whether two runs of G
     are bitwise equal), and G on three synthetic cases (`G_CASES`: 22
     columns with ragged rows and ids out of range on both sides, 7
     columns at the scalar atomic width, a warp whose ids are all equal);
 10b. runs G's sorted route (`torch.use_deterministic_algorithms(True)`)
     on phase 9's calls and on `G_CASES`: two runs bitwise equal, and
     equal to the plain version run on the CPU; times it beside the
     atomic route;
 10c. traces CLUSTER ray bundles that are not a pinhole frame:
     `render_rgb` without ``frame_hw`` at 256x256 with shadows (C's
     epilogue over F's sweep, then H) and `trace_hit` on 2,048 rays with
     scattered origins, each held against the same call on the plain
     versions (equal ids, masks and faces; images and t/u/v bit-equal);
 10d. holds H, and B on the same origins laid out planar, against their
     plain version on synthetic inputs over config 4's clusters at K = 1,
     the default and 32: a tile that lists every cluster with one free ray
     beside a tile with no active ray, rays that only their list's last
     work item occludes, 9x9 tiles (R = 81);
 11. takes the grad step with the plain versions on the card: equal ids,
     shadow masks and images, gradients within G's summation-order bar;
 12. takes five Adam steps (lr 1e-2) on positions and textures from a
     perturbed texture toward the image of the true one, and requires the
     loss after them to be below the loss before them;
 13. times the progressive and grad steps on both paths (the kernel path
     also by the profiler's device time summed over every activity) and
     C, H and G beside their plain versions, C and H also by profiler device time
     (their C entries' kernels, apart from the work-item split's PyTorch
     kernels), with the host's cost hidden, and at K = 1 to 16 (C) and 2
     to 32 (H) clusters per work item; for each of G's calls (shapes, kept
     rays and atomic width printed) also G in plain stream order (no
     programmatic dependent launch), `index_add_` alone and `torch.zeros`
     + `index_add_` on the same kept rows, each by events, by profiler
     device time and with the host's cost hidden (`time_queued`);
 14. builds config 2's scene through the public API on BRUTE (a
     15,488-triangle bumpy sphere standing in for suzanne.obj, and the
     reference's quad) with a 256x256 `Camera` and `RenderTarget`;
 15. clears the target through `Camera.clear` (kernel D, held exactly
     against `torch.full`) and traces it through `Camera.trace_scene`
     (kernel E), requiring both kernels launched and status 0;
 16. holds E against its plain version on the frame's rays (equal faces,
     t/u/v bit-equal) and D against its plain version and against
     `torch.full` at `CLEAR_SIZES` (1, 65,535, 65,536 and 1920x1088
     pixels), renders the frame with the plain versions (equal packed
     frames), prints the hit share and the status codes of the API's
     misuse cases, and times the frame, E and D beside their plain
     versions (E, D and `torch.full` also by profiler device time and
     with the host's cost hidden; E at 1, 2, 4 and 8 rays per thread and
     512-, 1,024- and 2,048-face chunks, each run bit-equal to plain);
 16b. holds E against its plain version on synthetic inputs (faces equal,
     t/u/v bit-equal, misses FLT_MAX, 0, 0, -1): a face copied across a
     face-chunk and a run boundary (the earlier face wins), origins
     inside a mesh with ``clip_backward_hits=False``, origins on mesh
     vertices (t = +-0.0 ties), degenerate faces, ray and face counts off
     the kernel's block shapes, a single ray;
 17. builds config 5's scene (three bumpy spheres of 69,451, 345,944 and
     100,002 triangles, reflectivity 0.3) and renders its 1920x1080 frame
     with two mirror bounces and shadows through `render_bounces`,
     requiring kernels A and B and two launches of kernel F;
 18. prints the active rays and cluster-list lengths of the primary
     pass, the shadows and each bounce, F's work items, K and active
     lanes per warp on each bounce, and the share of pixels the bounces
     change;
 19. holds A (with reflectivity) and B against their plain versions on
     that frame's inputs (A: slots equal, t/u/v bit-equal, attributes
     within 1e-5; B: equal masks), and F on each bounce's (the same as
     A);
 19b. holds C, A (with and without reflectivity) and F, the same way,
     against their plain versions on synthetic inputs over config 5's
     clusters: a tile that lists every cluster, an exact tie between a
     triangle and its copy a work item later (the earlier slot must win),
     ``clip_backward_hits=False`` from inside a mesh (hits at negative
     t), and for F one active ray;
 20. at 256x144, holds the cluster-route frame against the brute-force
     route's (kernel E): at least 99% of pixels within 1e-4; E on the
     brute route's primary rays equal to plain (t/u/v bit-equal); times
     E there and both routes' frames;
 21. times the frame, A, B and F per launch and one `sort_bounces=True`
     frame, F also by profiler device time and with the host's cost
     hidden (as C), and on both bounces at K = 4 to 64, A and B as in
     phase 29;
 22. runs config 1 at 256x256: `clear_buffer` (kernel D), `color_gradient`
     (kernel I) and `blob` at three times (kernel J; the first given as a
     float, passed by value), requiring each kernel launched and each frame
     `torch.uint32`, and 0xFF00FF00 to read back;
 23. at 256x256, 1920x1080 and 255x257 (`FILL_SIZES`) holds D equal to its
     plain version, I equal to its plain version and to a numpy transcription of `Gradient.cu`, J equal to its
     plain version at each time, J with a float time equal to J with the
     same time in a device tensor; requires two times to give two frames,
     and a traced `blob(..., 1.25)` to record no copy (no "Memcpy HtoD",
     no ``cudaMemcpy*`` call, no ``aten::copy_``; where
     `torch.tensor([1.25], device=cuda)` records one);
 24. times the config-1 frame (D then I) and `blob` through its entry
     point; D at `CLEAR_TIMED` (256x256, 1920x1080, 1920x1088), and at
     256x256 and 1920x1080 I and J (with a float time and
     with a device tensor), by events, by the profiler's device time and
     with the host's cost hidden, their outputs rotated over `FILL_KEEP`
     buffers so that a 1920x1080 frame's writes leave the L2, beside their
     plain versions and bounds at 4 bytes a pixel; with ``--parent DIR``,
     DIR's D, I and J in turns with this tree's (parent, this, this,
     parent), by events, on the card and with the host hidden, outputs
     equal by value (the parent's pixels as wide as its `PIXEL_BYTES`);
 25. writes a textured stand-in for suzanne.obj (15,488 triangles, two
     materials, a 64x64 24-bit BMP) and loads it through `load_model`,
     requiring the native OBJ tokenizer;
 26. runs the render CLI on it at 512x512 (three frames, 15 degrees of
     orbit each): lambert-shadow through `FrameRenderer` (A, B; with the
     per-phase profiler), parity on CLUSTER (C), parity on BRUTE at
     256x256 (E), and with ``--accel bvh`` parity (L) and lambert-shadow
     (L, and K's any hit for the shadows), requiring each route's kernels
     launched, and holds each launch of E against its plain version
     (t/u/v bit-equal);
 27. runs the same five CLI calls on the plain versions and holds the
     PNGs: the `FrameRenderer` lambert-shadow route within 1 per u8
     channel, every other route equal;
 28. runs the fly loop for four frames on BRUTE at 256x256 with a
     scripted event list, requiring the render targets 1, 2, 0, 1, and
     holds each launch of E against its plain version; then `fly.main`
     with its default ``--accel`` (BVH, kernel L) for the same four
     frames, its PNGs equal to the same run on the plain versions;
 29. times the bench frame (kernel path) by the profiler's device time,
     and A and B by profiler device time (their C entries' kernels) and
     at K = 1 to 16 (A) and 2 to 16 (B) clusters per work item, after
     every other phase;
 31. builds the LBVH of the bench frame's scene on the card with
     `build_bvh` (timed), requires every field bitwise equal to the same
     build on the CPU from the same tensors, and prints its nodes, leaves
     and leaf depth p50/p99 (`bvh_stats`);
 32. traces the 512x512 primary rays through `trace_bvh` and 2,048
     scattered rays through `trace_hit` (kernel K, closest hit), requiring
     K launched; holds K against its plain version (slots equal, t/u/v
     bit-equal) and against kernel E on the same rays (t bit-equal, faces
     equal but for exact-t ties, whose count it prints);
 33. traces the frame through `trace_hit` (kernel L, the tile beam) and
     holds L against its plain version (the same checks) and its slots
     and t against K's, also at tiles of 2x2 and 3x3; prints L's rounds
     (needed and launched) and host syncs a call, its work items a round
     (each round's held against `beam.split_queue`), the tiles that test
     triangles and the tests per such tile (max, mean), and holds every
     hit's key, decoded to its round, entry and k, to its output slot;
 33b. holds L, K (closest hit) and K (any hit) against their plain
     versions on small trees (`BVH_CASES`): queue 4 over many rounds
     (max_leaf_faces 4 and 1), 2 and 9 faces at max_leaf_faces 16 (no
     traversal leaves: a-link -1, first = -1) and doubled clouds (each hit
     an exact-t tie with its copy, the first in sequence order winning);
 34. casts the frame's shadow rays by `render_grad`'s rule (hit point +
     l * 10 t_epsilon, t_max FLT_MAX) through `any_hit_bvh` (kernel K, any
     hit): masks equal to its plain version's and to `any_hit_brute`'s;
 35. traces 256x256 rays through `trace_wavefront` (plain PyTorch on the
     card): faces equal to K's;
 36. builds config 2's scene through `Scene.create()` with no config
     (BVH) and traces its 256x256 frame through `Camera.trace_scene`
     (kernel L): equal to the same frame on the plain versions, timed
     (20 frames by events); renders
     the bench frame through the `FrameRenderer`'s BVH route with shadows
     (L, then K's any hit; E never launched): within 1 per u8 channel of
     its plain path, timed;
 37. times K (closest and any hit) and L by events, by the profiler's
     device time per recorded launch and with the host's cost hidden, and
     counts the work each needs on these inputs (ray-triangle tests and
     node tests) by instrumented plain runs; prints K's longest walk in
     steps and tests and its chain floor (the longest walk times one
     dependent load's latency, measured by `rt_chase` in a table L1 holds
     and in one of the tree's size), K on node rows in walk order and in
     the build's order (equal outputs), L's time by kernel (walk, test,
     epilogue) and L at 1, 2, 4 and 8 queue entries a work item;
 38. builds the hash grid of the bench frame's scene on the card with
     `build_grid` (timed), requires ``cell_start`` and ``entries`` bitwise
     equal to the same build on the CPU, and prints its live buckets,
     entries and faces per live bucket (`grid_stats`);
 39. renders the bench frame through the `FrameRenderer`'s GRID route
     (kernel M's march on pixel patches from the staged eye, then shadows
     by E), requiring M and E launched, within 1 per u8 channel of the
     same frame on the plain versions; holds M against its plain version
     on that frame's rays with the route's hints and without them (the
     plain march run once, inside the plain frame, counting its work), on
     2,048 scattered rays through `trace_hit` (blocks of consecutive rays,
     the general test) and on synthetic cases (the hash collision of
     `tests/test_grid.py:112` with axis-aligned rays from cell boundaries,
     axis-aligned and zero-component directions, ``max_search_iters`` 40,
     ``max_faces_per_cell`` 4, origins inside the mesh with
     ``clip_backward_hits`` on and off; the cases from the eye also with
     the hints): slots equal, t/u/v bit-equal; prints the hit share, the
     longest march, the tests per ray (mean, p99, max) and the plain
     march's count of M's work: the lane use of one thread a ray on row
     and pixel-patch warps and of the shared schedule, and the rows read
     when each distinct bucket of a block's step is read once;
 40. builds config 2's scene through `Scene.create(RenderConfig(accel=
     GRID))` and traces its 256x256 frame through `Camera.trace_scene`
     (M): equal to the plain path's frame, its hit pixels printed beside
     BRUTE's and the quad's truncated cells; runs the render CLI with
     ``--accel grid`` (parity and lambert, 128x128, three frames each, PNGs
     equal to the same runs on the plain versions) and requires its
     lambert-shadow route to raise, as the JAX package's does;
 41. times M by events over 20 launches and by the profiler's device
     time on the GRID frame's rays (also on its pixel patches without the
     staged eye, and without either hint, each equal), the GRID frame
     over 10 frames, `Camera.trace_scene` on GRID over 20,
     `build_shadow_grid` and `occlusion_grid` (plain PyTorch; its masks
     held equal to kernel E's any hit) on the GRID frame's shadow rays,
     and prints M's bound (its
     tests and steps, from the plain march's count), its work counters
     and its chain floor (the longest march's steps x two dependent loads
     x `rt_chase`'s latency); with ``--parent DIR`` (an unpacked parent
     commit) it builds DIR's kernels and times DIR's M in turns with this
     tree's on the same rays (parent, this, this, parent), by events and
     on the card, holding their outputs equal;
 30. prints the BVH and GRID routes' frames beside the CLUSTER bench
     frame (rays/s), and each kernel's time beside its bound: the larger
     of its FP32 operations at 67 TFLOP/s and its bytes at 3.35 TB/s,
     counted from this run's inputs (ray-triangle tests from the tile
     lists or the instrumented runs, 46 operations each; K's slab tests 23
     operations, L's node tests 61 and M's steps 41), and, for D and G,
     the time of the one PyTorch call that computes the same function
     (`torch.full`, `index_add_`), their device times and G's
     `torch.zeros` + `index_add_`.

 42. builds the edge table of config 4's scene (525,657 edges) and takes
     the step of ``sum(img * w)`` through `render_rgb_silhouette` at
     1024x1024 over (positions, eye, orient): its image bit-equal to
     `render_rgb`'s; C for the frame, C's epilogue over F's sweep for the
     boundary probes and G launched; prints the edges, silhouette edges,
     live samples and probe rays; requires `boundary_vjp`'s terms finite
     and nonzero and the probes' sweep bit-equal (t, u, v, slot) to its
     plain version; requires the terms bit-equal between the probes'
     screen order and the edges' order (`edge_grad._screen_order` set to
     the identity), prints the clusters listed a probe group in each
     order (counter ``general_pairs``) and times the probes' sweep in each
     by events; times the forward, the step, `render_rgb_vjp`'s step and
     `boundary_vjp` alone by events;
 43. the finite-difference check of `tests/test_torch_silhouette.py` on the
     card: the 9x9 flat triangle on BRUTE (kernel E), 2,048 samples an
     edge, Simpson's rule against the 64x box-filtered image, rtol 0.12;
 44. brings up the process group at world size 1 over NCCL
     (`parallel/mesh.initialize_distributed`, a free localhost port) and
     holds `render_sharded`, `progressive_step_sharded` (two steps,
     shadows) and one Adam step of `make_train_step` on config 4 at
     1024x1024 bit-equal to the unsharded calls (the Adam step against
     `torch.optim.Adam` on `render_rgb`'s gradient in one process, both
     under `torch.use_deterministic_algorithms(True)`, so G sorts);
 45. holds `render_bounces_sharded` on config 5 at 1920x1080 bit-equal to
     `render_bounces`;
 46. holds `trace_ring_sharded` on the bench frame's 512x512 primary rays
     bit-equal to `bounce_sweep.trace_rays`, and prints each sharded
     call's time beside its unsharded call's (events);
 47. spawns two ranks on the one card over gloo (which carries CUDA
     tensors in all-reduce and all-gather, not in send and receive): the
     config-4 render, two progressive steps and config 5's bounces
     bit-equal to the unsharded calls on both ranks, one Adam step's
     params equal on both ranks and within 1e-6 of their largest entry of
     one process's, the loss within 1e-6 relative; prints rank 0's times.

Phases 42-47 run after phase 13, before phase 14; phases 31-37 and then
38-41 after phase 28, before phase 29.  Every packed frame a phase reads
(the bench, config-1, config-2, BVH and GRID frames, `Camera.clear`'s and
the fly loop's) must be ``torch.uint32``, 4 bytes a pixel (`frame_bits`).
Any failure exits non-zero.
``--parent DIR`` is the only option (phases 24 and 41); the run needs
none.  The last two lines of standard output are a JSON object of
the kernels' counts, errors, times and bounds (A-J, the LBVH kernels K,
closest and any hit, and L, and the grid march M; every sweep's, D's,
E's, G's, I's, J's, K's, L's and M's with ``device_ms``, D's and G's with
``library_device_ms``, G's with ``library_zeroed_ms``; null elsewhere),
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

SIZE = 512
NUM_FACES = 69451  # bunny.obj's triangle count (BASELINE.json)
FRAMES = 50
# Config 4 (scripts/bench_configs.py:116-160): 1024x1024, the armadillo
# stand-in, and a textured stand-in of f16.obj's 4,056 triangles.
C4_SIZE = 1024
C4_ARMADILLO = 345944
C4_F16 = 4056
ADAM_STEPS = 5
# Config 2 (scripts/bench_configs.py:79-102): 256x256, BRUTE, suzanne.obj's
# 15,488 triangles (BASELINE.md:21) and the reference's quad.
C2_SIZE = 256
C2_SUZANNE = 15488
CLEAR_VALUE = 0xFF00FF00
# Kernel D against `torch.full`: one pixel, an odd count, 256², and
# config 5's edge-padded 1920x1088 frame.
CLEAR_SIZES = (1, 65535, 65536, 1920 * 1088)
# Kernel G's synthetic cases, name: (tiles, rays per tile, columns, rows,
# lowest id, highest id + 1, equal ids across warps): ragged rows and ids
# out of range on both sides at the float2 width; the scalar width; a warp
# (and a tile) whose ids are all equal at the float4 width.
G_CASES = {
    "d22_ragged": (16, 256, 22, 1001, -40, 1041, False),
    "d7_scalar": (16, 256, 7, 517, -1, 517, False),
    "equal_warp": (4, 256, 28, 64, -1, 64, True),
}
# Config 5 (scripts/bench_configs.py:164-200): 1920x1080, two bounces.
# The bunny stand-in sits on bunny.obj's bounding box: centre
# (-0.0168, 0.1101, -0.0016), half its largest extent as radius.
C5_WIDTH, C5_HEIGHT = 1920, 1080
C5_MESHES = (  # (faces, radius, centre, seed)
    (69451, 0.078, (-0.0168, 0.1101, -0.0016), 0),
    (345944, 0.9, (1.6, 0.8, 0.2), 2),
    (100002, 0.7, (-1.5, 0.6, -0.3), 3),
)
C5_SMALL = (256, 144)  # the frame held against the brute-force route
# Ray bundles that are not a pinhole frame (config 4's scene): render_rgb
# without frame_hw at this size, trace_hit on this many scattered rays.
BUNDLE_SIZE = 256
BUNDLE_RAYS = 2048
# Config 1 (scripts/bench_configs.py:67-75): 256x256 full-frame fills.
C1_SIZE = 256
BLOB_TIMES = (0.0, 1.25, 2.7)
# I and J are held against their plain versions at config 1's size, at
# config 5's 1920x1080 and at an odd size, and timed at the first two.
FILL_SIZES = ((C1_SIZE, C1_SIZE), (1920, 1080), (255, 257))
# Outputs a timed fill holds (`rotating`): 16 of 8.3 MB exceed the L2.
FILL_KEEP = 16
# Kernel D's timed sizes: config 1's, 1920x1080, config 5's edge-padded
# 1920x1088.
CLEAR_TIMED = ((C1_SIZE, C1_SIZE), (1920, 1080), (1920, 1088))
# The app path: the render CLI's default size, the fly loop's frames.
APP_SIZE = 512
FLY_SIZE = 256
FLY_FRAMES = 4
# Bounds (the H100 SXM's published peaks): FP32 outside
# the tensor cores, and device memory.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# The card's spin before `time_queued`'s calls: 2e7 cycles, about 10 ms
# at the H100's 1.98 GHz, long enough for the host to queue them all.
QUEUE_SPIN_CYCLES = 20_000_000
# FP32 operations of one Moller-Trumbore test in `csrc/sweep.cu:mt` and
# `csrc/brute.cu`: 45 adds, subtracts and multiplies, one division, and
# u + v (the comparisons are not counted).
MT_OPS = 46
# FP32 operations of kernel I a ramp position (a division and a multiply;
# a sixth of the pixels) and of kernel J a pixel (`csrc/frame.cu:
# blob_pixel`, counting min, max, abs and sqrt as one each) and a row (uy,
# s * uy and c * uy); sin and cos are not counted.
GRADIENT_OPS = 2
BLOB_OPS = 44
BLOB_ROW_OPS = 3
# FP32 operations the culls of `csrc/cull.cu` need (comparisons not
# counted): the frustum cull's five plane distances (11 each) a (tile,
# cluster) pair and a box centre and half extent (15) a cluster; the beam
# cull's three projection intervals (24 each) a cluster, whose (tile,
# cluster) test is comparisons alone.
FRUSTUM_PAIR_OPS = 55
FRUSTUM_CLUSTER_OPS = 15
BEAM_CLUSTER_OPS = 72
# The general cull's (tile, cluster) pair: per axis the box's two offsets
# from the origins' box, their products with the mean direction, a max
# and the sum (6), the gap (-whi, two max) and its square summed (5);
# then a square root and a product.
GENERAL_PAIR_OPS = 35
#: How near its threshold a cull test whose outcome differs between a cull
#: kernel and its chain may lie, relative to the magnitudes it adds: ~170
#: float32 ulps, the room of a 256-term sum taken in another order.
CULL_THRESHOLD_REL = 1e-5
REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_cuda(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_activities(fn, iters: int) -> dict:
    """``{activity name: (device ms per call, occurrences recorded)}``:
    the kernels, copies and fills that `torch.profiler` records over
    ``iters`` calls of ``fn`` back to back, after a warm-up ({} when it
    records none).  Each activity's time per call is its mean over the
    occurrences recorded times its occurrences per call.  ``fn`` does the
    same work every call, so that count is the recorded one over ``iters``
    rounded up: exact while fewer than ``iters`` of an activity's
    occurrences were dropped.  The profiler has kept as few as one in ten
    of kernel L's launches (PERF.md §7), which a division by ``iters``
    would read as a tenth of the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us and e.count:
            out[e.key] = (us / 1e3 / e.count * math.ceil(e.count / iters),
                          e.count)
    return out


def device_ms(fn, iters: int, kernels=None) -> tuple:
    """``(mine, rest, recorded)``: `device_activities` of ``fn`` summed,
    ms per call.  ``mine`` sums the kernels named in ``kernels`` (names
    without template arguments; every activity when None), ``rest`` the
    others; ``recorded`` is the fewest occurrences recorded of any of
    ``mine``.  (None, None, 0) when the profiler records nothing.
    Kernels that overlap (G's fill and scatter under programmatic
    dependent launch) each count whole, so a sum can exceed the card's
    span; `time_queued` gives the span."""
    acts = device_activities(fn, iters)
    if not acts:
        return None, None, 0
    mine = {name: v for name, v in acts.items() if kernels is None
            or short_kernel_name(name).split("<")[0] in kernels}
    rest = sum(ms for name, (ms, _) in acts.items() if name not in mine)
    return (sum(ms for ms, _ in mine.values()) or None, rest,
            min((n for _, n in mine.values()), default=0))


def short_kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespace and
    parameter list: ``scatter_add_kernel<4>``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def time_queued(fn, iters: int):
    """Mean milliseconds per call of ``fn`` on the card with the host's
    cost hidden: the card first spins (`torch.cuda._sleep`) while the host
    queues all ``iters`` calls, so the events time the card's kernels and
    the gaps between them.  None when the host was not done queueing
    before the spin ended."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    hidden = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if hidden else None


def ms_text(ms) -> str:
    """A time for the log: ms to four decimals, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def share_text(bound_ms, ms) -> str:
    """``bound_ms`` as a share of ``ms``, or "not measured"."""
    return "not measured" if ms is None else f"{bound_ms / ms:.2%}"


def time_once(fn):
    """``(fn(), milliseconds)`` of one call on the card, no warm-up: for
    plain versions too slow to run twice."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*xs) -> int:
    """Bytes of the tensors in ``xs`` (tensors, or tuples of them such as
    `TileLists`); other values count 0."""
    import torch

    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, tuple):
            total += nbytes(*x)
    return total


def bound(ops: float, moved: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: the
    larger of ``ops`` FP32 operations at the FP32 peak and ``moved`` bytes
    at the device memory rate."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweep_tests(lists, rays_per_tile, g, active=None, occluded=None) -> int:
    """Ray-triangle tests a tile sweep needs on these inputs: every listed
    cluster's ``g`` triangles for each ray of its tile (``active`` [T, R]
    rays only, when given).  For an any-hit sweep (``occluded`` [T, R]),
    only the rays that find no hit must test the whole list; an occluded
    ray needs one test."""
    counts = lists.counts.long()
    if active is None:
        return int(counts.sum()) * rays_per_tile * g
    free = active if occluded is None else active & ~occluded
    tests = int((counts * free.sum(dim=1)).sum()) * g
    if occluded is not None:
        tests += int((active & occluded).sum())
    return tests


def kernel_record(name, source, replaces, launches, err, ms, plain_ms,
                  bound_ms_by, library_ms=None, device_ms=None,
                  library_device_ms=None, library_zeroed_ms=None) -> dict:
    """One entry of the kernels line.  ``device_ms`` and
    ``library_device_ms`` are profiler device times per call (C, D, F and
    G; the library's D and G); ``library_zeroed_ms`` is G's
    `torch.zeros` + `index_add_`."""
    bound_ms, bound_by = bound_ms_by
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "device_ms": device_ms, "library_device_ms": library_device_ms,
            "library_zeroed_ms": library_zeroed_ms}


def occlusion_err(k, p, name: str) -> float:
    """Require an any-hit kernel's mask ``k`` equal to its plain version's
    ``p``; returns the largest difference (0)."""
    import torch

    check(torch.equal(k, p), f"{name}: masks differ from plain: "
          f"{int((k != p).sum())} rays")
    return float((k.int() - p.int()).abs().max())


def sync_device(dev) -> None:
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bits_equal(x, y) -> bool:
    """Whether two float32 tensors hold the same bits (-0.0 is not 0.0)."""
    import torch

    return torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32))


def closest_err(k, p, name: str) -> tuple[int, int]:
    """Hold a split sweep's (t, u, v, slot) ``k`` against its plain
    version's ``p`` (kernel C, C's epilogue over F's sweep, and A's and
    F's first planes): slots equal, t/u/v bit-equal.  Returns the number
    of hit rays and of hits at a negative t."""
    import torch

    check(torch.equal(k[3], p[3]), f"{name}: slots differ from plain: "
          f"{int((k[3] != p[3]).sum())} rays")
    for i, plane in enumerate("tuv"):
        check(bits_equal(k[i], p[i]), f"{name}: {plane} not bit-equal to "
              f"plain on {int((k[i].view(torch.int32) != p[i].view(torch.int32)).sum())} rays")
    hit = p[0] < float(3.4028234663852886e38)
    return int(hit.sum()), int((hit & (p[0] < 0)).sum())


def shade_err(k, p, name: str) -> tuple[float, int, int]:
    """Hold a shading kernel's planes ``k`` (t, slot, u, v, attributes;
    kernels A and F) against its plain version's ``p``: `closest_err` on
    t, u, v and slot, the attributes within 1e-5.  Returns the largest
    attribute error, the hit rays and the hits at a negative t."""
    hits, negative = closest_err((k[0], k[2], k[3], k[1]),
                                 (p[0], p[2], p[3], p[1]), name)
    err = 0.0
    for i in range(4, len(p)):
        d = float((k[i] - p[i]).abs().max())
        check(d <= 1e-5, f"{name} plane {i}: max abs err {d}")
        err = max(err, d)
    return err, hits, negative


def split_stats(lists, k: int, rays_per_tile: int, active=None):
    """A split sweep's work on these lists at K = ``k``: the real work
    items, and the mean active lanes of the warps that test (every ray of
    A's and C's tiles; B's, F's and H's active rays, packed into the
    leading lanes)."""
    import torch

    per_tile = (lists.counts.long() + k - 1) // k
    lanes = (active.sum(dim=1).long() if active is not None
             else torch.full_like(per_tile, rays_per_tile))
    warps = int((per_tile * ((lanes + 31) // 32)).sum())
    lane_sum = float((per_tile * lanes).sum())
    return int(per_tile.sum()), lane_sum / warps if warps else 0.0


#: The kernels of the split C entries, by the profiler's names: A's, C's
#: and F's key fill and two passes, B's and H's flag clear and pass
#: (`csrc/sweep.cu`), E's key fill and two passes (`csrc/brute.cu`).
SPLIT_KERNELS = ("fill_keys_kernel", "sweep_items_kernel",
                 "closest_epilogue_kernel", "shade_epilogue_kernel",
                 "clear_flags_kernel", "occlusion_items_kernel",
                 "brute_items_kernel", "brute_epilogue_kernel")


def scatter_err(k, p, idx, num_rows: int, name: str) -> float:
    """Hold kernel G's output ``k`` against its plain version's ``p``:
    rows that no kept id names exactly 0.0, the rest within G's
    summation-order bar, |k - p| <= 1e-5 max|p| + 1e-6.  Returns the
    largest absolute error."""
    import torch

    flat = idx.reshape(-1).long()
    kept = flat[(flat >= 0) & (flat < num_rows)]
    touched = torch.bincount(kept, minlength=num_rows) > 0
    check(bool((k[~touched] == 0.0).all()),
          f"{name}: {int((k[~touched] != 0.0).any(dim=1).sum())} untouched "
          "rows are not 0.0")
    err = float((k - p).abs().max()) if k.numel() else 0.0
    bar = 1e-5 * float(p.abs().max()) + 1e-6 if p.numel() else 1e-6
    check(err <= bar, f"{name}: max abs err {err} > {bar}")
    return err


def scatter_cases(dev) -> float:
    """Kernel G against its plain version on `G_CASES`; returns the largest
    absolute error."""
    import numpy as np
    import torch

    from raytracercuda_torch.diff import scatter

    worst = 0.0
    for name, (t, b, d, rows, lo, hi, equal) in G_CASES.items():
        rng = np.random.default_rng(sorted(G_CASES).index(name))
        ids = rng.integers(lo, hi, (t, b))
        if equal:
            ids[0, 32:64] = 5  # the second warp of tile 0
            ids[1, :] = rows - 1  # and every warp of tile 1
        idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
        g = torch.from_numpy(rng.normal(size=(t, d, b)).astype(
            np.float32)).to(dev)
        k = scatter._scatter_add_cuda(g, idx, rows)
        p = scatter._scatter_add_plain(g, idx, rows)
        err = scatter_err(k, p, idx, rows, f"kernel G ({name})")
        worst = max(worst, err)
        print(f"kernel G matches plain on {name}: g {(t, d, b)} -> {rows} "
              f"rows, atomic width {scatter._atomic_width(d)}, ids "
              f"[{lo}, {hi}), max abs err {err:.3g}, untouched rows 0.0")
    return worst


def write_bmp(path: str, rgb, bpp: int = 24, top_down: bool = False) -> None:
    """Write ``[H, W, 3]`` uint8 RGB as an uncompressed BMP: 8-bit paletted
    (at most 256 colours), 24- or 32-bit; rows bottom-up unless
    ``top_down`` (a negative height)."""
    import struct

    import numpy as np

    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    palette = b""
    if bpp == 8:
        colours, index = np.unique(rgb.reshape(-1, 3), axis=0,
                                   return_inverse=True)
        if len(colours) > 256:
            raise ValueError(f"{len(colours)} colours for an 8-bit BMP")
        pal = np.zeros((256, 4), np.uint8)
        pal[:len(colours), :3] = colours[:, ::-1]  # BGRA entries
        palette = pal.tobytes()
        px = index.reshape(h, w, 1).astype(np.uint8)
    elif bpp in (24, 32):
        px = rgb[..., ::-1]  # BGR
        if bpp == 32:
            px = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], 2)
    else:
        raise ValueError(f"bpp {bpp}")
    nch = px.shape[2]
    rows = np.zeros((h, (w * nch + 3) & ~3), np.uint8)
    rows[:, :w * nch] = px.reshape(h, w * nch)
    data = (rows if top_down else rows[::-1]).tobytes()
    offset = 14 + 40 + len(palette)
    header = struct.pack("<2sIHHI", b"BM", offset + len(data), 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       0, len(data), 2835, 2835, 256 if bpp == 8 else 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + palette + data)


def write_textured_obj(directory: str, faces: int = C2_SUZANNE,
                       tex_size: int = 64, seed: int = 0) -> str:
    """A textured stand-in for suzanne.obj, written into ``directory``:
    ``bumpy_sphere_mesh(faces)`` at the origin as OBJ text with
    ``v/vt/vn`` corners; its first half of faces in material ``skin``
    (Kd 0.9 0.7 0.5, ``map_Kd`` a ``tex_size``² 24-bit BMP of seeded
    texels), the rest in ``eyes`` (Kd 0.2 0.3 0.8, untextured), both named
    by one ``mtllib``.  Returns the OBJ's path."""
    import numpy as np

    from raytracercuda_torch.models.mesh import (VERTEX_DATA_NORMAL,
                                                 VERTEX_DATA_UV1)
    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh

    mesh = bumpy_sphere_mesh(faces, center=(0.0, 0.0, 0.0), seed=seed)
    tri = mesh.indices.reshape(-1, 3).astype(np.int64) + 1
    write_bmp(os.path.join(directory, "skin.bmp"),
              np.random.default_rng(seed).integers(
                  0, 256, (tex_size, tex_size, 3), dtype=np.uint8))
    with open(os.path.join(directory, "model.mtl"), "w") as f:
        f.write("newmtl skin\nKd 0.9 0.7 0.5\nmap_Kd skin.bmp\n"
                "newmtl eyes\nKd 0.2 0.3 0.8\n")

    def rows(tag, a):
        return [f"{tag} " + " ".join(f"{x:.9g}" for x in r) for r in a]

    half = len(tri) // 2
    corner = [" ".join(f"{i}/{i}/{i}" for i in t) for t in tri]
    lines = (["mtllib model.mtl"] + rows("v", mesh.positions)
             + rows("vt", mesh.vertex_data(VERTEX_DATA_UV1))
             + rows("vn", mesh.vertex_data(VERTEX_DATA_NORMAL))
             + ["usemtl skin"] + [f"f {c}" for c in corner[:half]]
             + ["usemtl eyes"] + [f"f {c}" for c in corner[half:]])
    path = os.path.join(directory, "model.obj")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


class PhaseClock:
    """Prints the seconds each phase took (host clock, after a sync)."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.2f} s")
        self.t = now


class Recorder:
    """Swap a module's functions for ones that remember their arguments
    (every call's) and call through; `restore` puts them back."""

    def __init__(self, module, names):
        self.module = module
        self.real = {n: getattr(module, n) for n in names}
        self.calls = {n: [] for n in names}
        for n, fn in self.real.items():
            setattr(module, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def run(*args):
            self.calls[name].append(args)
            return fn(*args)
        return run

    def restore(self):
        for n, fn in self.real.items():
            setattr(self.module, n, fn)


def staged_rows_check(sweep, kind: str, launch, args, name: str):
    """``launch(*args)`` (A's or C's wrapper with ``kind`` "eye", B's or
    H's with "light") with `sweep._staged_table` recorded: the one table
    its C entry staged must equal the plain builder's (`_eye_rows_plain`,
    `_light_rows_plain`) on the same eye or light (``args[1]``) and
    geometry rows, bit for bit.  Returns the launch's output."""
    import torch

    make = sweep._staged_table
    tables = []

    def record(geom):
        table = make(geom)
        tables.append((table, geom))
        return table

    sweep._staged_table = record
    try:
        out = launch(*args)
    finally:
        sweep._staged_table = make
    sync_device(args[1].device)
    check(len(tables) == 1, f"{name}: {len(tables)} staged tables")
    table, geom = tables[0]
    plain = (sweep._eye_rows_plain if kind == "eye"
             else sweep._light_rows_plain)(args[1], geom)
    differ = int((table.view(torch.int32) != plain.view(torch.int32)).sum())
    check(differ == 0, f"{name}: {differ} of {table.numel()} floats of the "
          f"staged {kind} rows differ from plain")
    flagged = f", {int((table[..., 13] != 0).sum())} flagged degenerate" \
        if kind == "light" else ""
    print(f"{name}: staged {kind} rows {tuple(table.shape)} bit-equal to "
          f"plain{flagged}")
    return out


def staged_counts(launches: dict, where: str) -> None:
    """The staged tables' launch counts match the sweeps that read them:
    eye rows A + C, light rows B + H; F and the ray bundles' closest hit
    stage none."""
    check(launches["eye_rows"] == launches["primary_shade"]
          + launches["primary"] and launches["light_rows"]
          == launches["occlusion"] + launches["occlusion_rows"],
          f"{where}: staged tables do not match the sweeps: {launches}")


class PlainOnCard:
    """Within it, the CUDA wrappers of the given modules run their plain
    versions: ``{module: {cuda_name: plain_fn}}``."""

    def __init__(self, swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, d in self.swaps.items()
                      for n in d]
        for m, d in self.swaps.items():
            for n, fn in d.items():
                setattr(m, n, fn)

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def config4_scene(dev, armadillo_faces, f16_faces):
    """Config 4's scene (scripts/bench_configs.py:116-136): the armadillo
    stand-in ``bumpy_sphere_mesh(345944, radius=4, center=(0, -1, 14),
    seed=2)`` and, in place of f16.obj (which the repository does not
    ship), a textured bumpy sphere of its 4,056 triangles with a seeded
    256x256 texture; clusters built once; the eye backed off by twice the
    extent (`frame_eye`, :59-64), orient the identity."""
    import numpy as np
    import torch

    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
    from raytracercuda_torch.models.scene import Material, Scene

    config = RenderConfig(accel=AccelKind.CLUSTER)
    scene = Scene(config, device=dev)
    # As there: material 0 is the scene's default (white, untextured),
    # which the armadillo stand-in keeps; the loaded model's material
    # (here: textured) comes after it.
    f16 = bumpy_sphere_mesh(f16_faces, radius=2.0, center=(2.0, 3.0, 7.0),
                            bump=0.3, seed=7)
    f16.material_id = 1
    scene.add_mesh(f16)
    scene.add_mesh(bumpy_sphere_mesh(armadillo_faces, radius=4.0,
                                     center=(0, -1, 14), seed=2))
    scene.materials = [Material(), Material(texture_id=0)]
    scene.textures = [np.random.default_rng(4).random((256, 256, 3))]
    data = scene.data()
    accel = scene.accel
    lo = data.positions.amin(dim=0)
    hi = data.positions.amax(dim=0)
    extent = float((hi - lo).amax())
    eye = ((lo + hi) / 2 - torch.tensor([0.0, 0.0, 2.0 * extent],
                                        device=dev)).to(torch.float32)
    return config, data, accel, eye, torch.eye(3, device=dev)


def frustum_margin(d, eye, cmin, cmax, tile_px, planar, tiles, clusters):
    """How near its threshold the frustum chain's test lies at each
    (``tiles``, ``clusters``) pair of the cull of ``d`` (planar
    ``[T, 3, R]``, else ``[T, R, 3]``): ``|min_p dist_p| / scale`` of the
    five plane distances, in float64, 0 on the threshold."""
    from raytracercuda_torch.trace import sweep

    planes = (sweep.tile_planes_planar(d, tile_px) if planar
              else sweep.tile_frustum_planes(d, tile_px))
    planes = planes[tiles].double()  # [K, 5, 3]
    mid = ((cmin + cmax) * 0.5 - eye)[clusters].double()[:, None]
    half = ((cmax - cmin) * 0.5)[clusters].double()[:, None]
    dist = (planes * mid).sum(-1) + (planes.abs() * half).sum(-1)
    scale = (planes * mid).abs().sum(-1) + (planes.abs() * half).sum(-1)
    return (dist / (scale + 1e-30)).amin(dim=1).abs()


def beam_margin(o, act, light_dir, cmin, cmax, planar, tiles, clusters):
    """As `frustum_margin`, for the swept-beam chain's five interval tests
    (inf where the tile has no active ray: its row is false either
    way)."""
    import torch

    from raytracercuda_torch.trace import occlusion_cull

    beam = (occlusion_cull.swept_tile_beams_planar if planar
            else occlusion_cull.swept_tile_beams)(o, act, light_dir)
    lo, hi = cmin[clusters].double(), cmax[clusters].double()
    c, h = (lo + hi) * 0.5, (hi - lo) * 0.5

    def proj(axis):
        a = axis.double()
        return c @ a, h @ a.abs()

    (cu, hu), (cv, hv), (cl, hl) = (proj(beam.u_ax), proj(beam.v_ax),
                                    proj(beam.l))
    ou_lo, ou_hi, ov_lo, ov_hi, ol_lo = (
        x[tiles].double() for x in (beam.ou_lo, beam.ou_hi, beam.ov_lo,
                                    beam.ov_hi, beam.ol_lo))
    tests = [(cu + hu) - ou_lo, ou_hi - (cu - hu), (cv + hv) - ov_lo,
             ov_hi - (cv - hv), (cl + hl) - ol_lo]
    scales = [cu.abs() + hu + ou_lo.abs(), cu.abs() + hu + ou_hi.abs(),
              cv.abs() + hv + ov_lo.abs(), cv.abs() + hv + ov_hi.abs(),
              cl.abs() + hl + ol_lo.abs()]
    rel = torch.stack([m / (s + 1e-30) for m, s in zip(tests, scales)])
    return torch.where(beam.tile_any[tiles], rel.amin(dim=0).abs(),
                       torch.inf)


def general_margin(o3, d3, act, cmin, cmax, tiles, clusters):
    """As `frustum_margin`, for the general chain's tests
    (`bounce_sweep._general_cull_plain`): the per-axis reach tests, the
    sign of cos_min and the cone test, each relative to the larger of 1
    and its terms' magnitudes (inf where the tile has no active ray: its
    row is false either way)."""
    import torch

    inf = torch.inf
    o, d, a = o3.double(), d3.double(), act[:, None, :]
    omin = torch.where(a, o, inf).amin(dim=2)
    omax = torch.where(a, o, -inf).amax(dim=2)
    dmin = torch.where(a, d, inf).amin(dim=2)
    dmax = torch.where(a, d, -inf).amax(dim=2)
    dsum = torch.where(a, d, 0.0).sum(dim=2)
    m = dsum / dsum.norm(dim=1, keepdim=True).clamp(min=1e-15)
    cos_min = torch.where(act, (d * m[:, :, None]).sum(dim=1),
                          1.0).amin(dim=1)
    omin, omax, dmin, dmax, m, cos_min = (
        x[tiles] for x in (omin, omax, dmin, dmax, m, cos_min))
    lo, hi = cmin[clusters].double(), cmax[clusters].double()

    def rel(x, y):
        return (x - y).abs() / torch.maximum(x.abs(), y.abs()).clamp(min=1.0)

    margins = [cos_min.abs()]
    sup = gap2 = 0.0
    for i in range(3):
        margins.append(torch.where(dmin[:, i] >= 0.0,
                                   rel(hi[:, i], omin[:, i]), inf))
        margins.append(torch.where(dmax[:, i] <= 0.0,
                                   rel(lo[:, i], omax[:, i]), inf))
        wlo = lo[:, i] - omax[:, i]
        whi = hi[:, i] - omin[:, i]
        sup = sup + torch.maximum(m[:, i] * wlo, m[:, i] * whi)
        gap2 = gap2 + torch.maximum(wlo, -whi).clamp(min=0.0) ** 2
    margins.append(rel(sup, cos_min * gap2.sqrt()))
    return torch.where(act.any(dim=1)[tiles],
                       torch.stack(margins).amin(dim=0), inf)


def cull_path(dev, clock, renderer, eye, orient, rays, c4, c5,
              size=C4_SIZE, width=C5_WIDTH, height=C5_HEIGHT):
    """Phases 6b-6c: the three cull kernels (`csrc/cull.cu`) against their
    plain chains on the card, on the bench frame (A's and B's planar
    tiles), on config 4's progressive pass (``c4``, C's and H's row-major
    tiles) and on config 5's two-bounce frame (``c5``, the scene of
    `config5_scene`: A's and B's tiles and each bounce's general cull):
    one launch of each a cull, the frame and the pass bit-equal to the
    chains' route, each kernel's mask against its chain's on the unit's
    inputs (the frustum and beam culls' in both layouts; an entry may
    differ only where the chain's test lies within `CULL_THRESHOLD_REL`
    of its threshold), the lists, and each timed by CUDA events.  Returns
    the three kernels' JSON records (``max_abs_err``: differing mask
    entries)."""
    import torch

    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import bounce_sweep, sweep
    from raytracercuda_torch.trace.bounce import render_bounces
    from raytracercuda_torch.trace.pipeline import rotate_rays
    from raytracercuda_torch.trace.progressive import (init_progressive,
                                                       progressive_step)

    # wrapper -> (module, launch count, plain chain, margin, layouts)
    kinds = {"_frustum_cull_cuda": (sweep, "frustum_cull",
                                    sweep._frustum_cull_plain,
                                    frustum_margin, 2),
             "_beam_cull_cuda": (sweep, "beam_cull", sweep._beam_cull_plain,
                                 beam_margin, 2),
             "_general_cull_cuda": (bounce_sweep, "general_cull",
                                    bounce_sweep._general_cull_plain,
                                    general_margin, 1)}
    stats = {name: {"differ": 0, "launches": 0, "ms": [], "plain_ms": [],
                    "bound": []} for name in kinds}

    def ops(name, t_, c_):
        if name == "_frustum_cull_cuda":
            return t_ * c_ * FRUSTUM_PAIR_OPS + c_ * FRUSTUM_CLUSTER_OPS
        if name == "_general_cull_cuda":
            return t_ * c_ * GENERAL_PAIR_OPS
        return c_ * BEAM_CLUSTER_OPS

    def layouts(args, planar_layouts):
        if planar_layouts == 1:
            return (("as called", args),)
        x, planar = args[0], args[-1]
        return (("as called", args), ("other layout", (
            x.transpose(1, 2).contiguous(), *args[1:-1], not planar)))

    def unit(what, run, want):
        recs = [Recorder(module, [n for n, k in kinds.items()
                                  if k[0] is module])
                for module in (sweep, bounce_sweep)]
        try:
            sweep.reset_launch_counts()
            got = run()
            torch.cuda.synchronize()
            launches = {kinds[n][1]: sweep.launch_counts[kinds[n][1]]
                        for n in kinds}
        finally:
            for rec in recs:
                rec.restore()
        check(launches == want,
              f"{what}: cull launches {launches}, want {want}")
        with PlainOnCard({module: {n: k[2] for n, k in kinds.items()
                                   if k[0] is module}
                          for module in (sweep, bounce_sweep)}):
            want_out = run()
            torch.cuda.synchronize()
        check(torch.equal(got, want_out),
              f"{what}: not bit-equal to the plain chains' route")
        calls = {**recs[0].calls, **recs[1].calls}
        for name, (_, key, plain, margin, n_layouts) in kinds.items():
            if not calls[name]:
                continue
            kernel = getattr(kinds[name][0], name)
            st = stats[name]
            st["launches"] += len(calls[name])
            for i, args in enumerate(calls[name]):
                call = f"{key} {i + 1}" if len(calls[name]) > 1 else key
                for layout, a in layouts(args, n_layouts):
                    k, p = kernel(*a), plain(*a)
                    bad = (k != p).nonzero()
                    worst = (float(margin(*a, bad[:, 0], bad[:, 1]).max())
                             if len(bad) else 0.0)
                    kl, pl = sweep._tile_lists(k), sweep._tile_lists(p)
                    same = all(torch.equal(u, v) for u, v in zip(kl, pl))
                    st["differ"] += len(bad)
                    print(f"{what}, {call} ({layout}): {len(bad)} of "
                          f"{k.numel()} mask entries differ from the chain "
                          f"(largest relative margin {worst:.3g}), lists "
                          f"{'equal' if same else 'differ'}; "
                          f"{int(k.sum())} survive")
                    check(worst <= CULL_THRESHOLD_REL,
                          f"{what}, {call} ({layout}): a mask entry differs "
                          f"{worst:.3g} from its threshold, beyond "
                          f"{CULL_THRESHOLD_REL}")
            args = calls[name][0]
            ms = time_cuda(lambda: kernel(*args), 50)
            plain_ms = time_cuda(lambda: plain(*args), 20)
            queued = time_queued(lambda: kernel(*args), 50)
            t_, c_ = args[0].shape[0], args[3].shape[0]  # [C, 3] boxes
            moved = nbytes(*args[:5]) + t_ * c_
            st["ms"].append(ms)
            st["plain_ms"].append(plain_ms)
            st["bound"].append(bound(ops(name, t_, c_), moved))
            b_ms, b_by = st["bound"][-1]
            print(f"{what}, {key}: kernel {ms:.4f} ms (host hidden "
                  f"{ms_text(queued)}), chain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.6f} ms by {b_by} ({t_} tiles x {c_} clusters, "
                  f"{moved} bytes)")
        return got

    one_each = {"frustum_cull": 1, "beam_cull": 1, "general_cull": 0}

    # 6b. The bench frame: A's and B's planar tiles.
    unit("bench frame", lambda: renderer.render(eye, orient, rays), one_each)
    clock.done("6b (culls, bench frame)")

    # 6c. Config 4's progressive pass: C's and H's row-major tiles; config
    # 5's frame: A's and B's, and each bounce's general cull.
    config, data, accel, c4_eye, c4_orient = c4

    def first_pass():
        with torch.no_grad():
            return progressive_step(
                init_progressive(size * size, device=dev), data, accel,
                c4_eye, c4_orient, size, size, config,
                with_shadows=True).image

    unit("config 4 pass", first_pass, one_each)
    config, data, accel, c5_eye = c5
    dirs = rotate_rays(camera_ray_grid(width, height, device=dev),
                       torch.eye(3, device=dev))
    unit("config 5 frame", lambda: render_bounces(
        accel, data, c5_eye, dirs, height, width, config, num_bounces=2),
         {**one_each, "general_cull": 2})
    clock.done("6c (culls, config 4 pass, config 5 frame)")
    src = "raytracercuda_torch/csrc/cull.cu"
    replaces = {"_frustum_cull_cuda": "the frustum cull's PyTorch chain "
                "(dense._cull_frustum; no TPU kernel)",
                "_beam_cull_cuda": "the swept-beam cull's PyTorch chain "
                "(occlusion_cull.beam_survive_matrix; no TPU kernel)",
                "_general_cull_cuda": "the general cull's PyTorch chain "
                "(bounce_sweep._general_cull_plain; no TPU kernel)"}
    return [kernel_record(kinds[n][1], src, replaces[n], st["launches"],
                          float(st["differ"]), st["ms"][0], st["plain_ms"][0],
                          st["bound"][0]) for n, st in stats.items()]


def shade_path(dev, clock, renderer, eye, orient, rays):
    """Phase 6d: the CLUSTER frame's shading kernels (`csrc/frame.cu`:
    `shadow_setup_kernel` in ``frame.shadow_rays``, `frame_shade_kernel`
    in ``frame.shade``) against the plain phases (`shade._shadow_setup_plain`,
    `_frame_shade_plain`) on the bench frame's inputs: one launch of each
    a frame, the frame bit-equal to the plain phases' route, the set-up's
    n.l, mask and origins and the shade's framebuffer bit-equal; each
    timed by CUDA events, with the host hidden and by the profiler,
    beside its chain and a bytes bound (the planes read and written, and
    four texels of 12 bytes a textured hit).  Returns the two kernels'
    JSON records."""
    import torch

    from raytracercuda_torch.trace import shade
    from raytracercuda_torch.types import FLT_MAX

    names = ("_shadow_setup_cuda", "_frame_shade_cuda")
    plains = {n: getattr(shade, n.replace("_cuda", "_plain")) for n in names}
    rec = Recorder(shade, names)
    try:
        shade.reset_launch_counts()
        frame = renderer.render(eye, orient, rays)
        torch.cuda.synchronize()
        launches = dict(shade.launch_counts)
    finally:
        rec.restore()
    check(launches == {"shadow_setup": 1, "frame_shade": 1},
          f"bench frame: shading launches {launches}, want one of each")
    with PlainOnCard({shade: plains}):
        plain_frame = renderer.render(eye, orient, rays)
        torch.cuda.synchronize()
    check(torch.equal(frame_bits(frame, "bench frame"),
                      frame_bits(plain_frame, "plain phases' frame")),
          "bench frame: not bit-equal to the plain phases' route")
    s_args = rec.calls["_shadow_setup_cuda"][0]
    f_args = rec.calls["_frame_shade_cuda"][0]
    got = shade._shadow_setup_cuda(*s_args)
    want = shade._shadow_setup_plain(*s_args)
    torch.cuda.synchronize()
    differ = {name: int((k.view(torch.int32) != p.view(torch.int32)).sum()
                        if k.dtype == torch.float32 else (k != p).sum())
              for name, k, p in zip(("n.l", "active", "origins"), got,
                                    want)}
    check(not any(differ.values()),
          f"shadow set-up: values differ from plain: {differ}")
    k_frame = shade._frame_shade_cuda(*f_args)
    p_frame = shade._frame_shade_plain(*f_args)
    torch.cuda.synchronize()
    px_differ = int((frame_bits(k_frame, "shade kernel")
                     != frame_bits(p_frame, "plain shade")).sum())
    check(px_differ == 0, f"frame shade: {px_differ} pixels differ from "
          f"plain")
    outs, ndotl, shadow, textures, has_uv = f_args[:5]
    hit = outs[0] < float(FLT_MAX)
    textured = shade._textured(textures, has_uv)
    tex_hits = int((hit & (outs[10].to(torch.int32) >= 0)).sum()) \
        if textured else 0
    n = outs[0].numel()
    print(f"shading kernels match plain on the bench frame: {int(hit.sum())}"
          f" hits of {n} pixels, {tex_hits} textured, "
          f"{int(got[1].sum())} shadow rays, {int(shadow.sum())} shadowed; "
          f"frame bit-equal to the plain phases' route")
    clock.done("6d (shading kernels vs plain)")

    moved = {"_shadow_setup_cuda": nbytes(outs[0], *outs[4:7], s_args[1],
                                          *got),
             "_frame_shade_cuda": nbytes(outs[0], ndotl, shadow,
                                         *outs[7:10], k_frame)
             + (nbytes(*outs[10:13]) + tex_hits * 4 * 3 * 4 if textured
                else 0)}
    kernels = {"_shadow_setup_cuda": ("shadow_setup", s_args,
                                      "shadow_setup_kernel"),
               "_frame_shade_cuda": ("frame_shade", f_args,
                                     "frame_shade_kernel")}
    src = "raytracercuda_torch/csrc/frame.cu"
    replaces = {"_shadow_setup_cuda": "the frame's shadow-ray set-up chain "
                "(shade.faced_ndotl_planar, shadow_origins_planar; XLA ops "
                "in JAX, no TPU kernel)",
                "_frame_shade_cuda": "the frame's shade chain "
                "(shade.lambert_planar, sample_texture, pack_rgb, "
                "untile_pixels; XLA ops in JAX, no TPU kernel)"}
    records = []
    for name, (key, args, kname) in kernels.items():
        kernel, plain = getattr(shade, name), plains[name]
        ms = time_cuda(lambda: kernel(*args), 50)
        plain_ms = time_cuda(lambda: plain(*args), 20)
        queued = time_queued(lambda: kernel(*args), 50)
        dev_ms = device_ms(lambda: kernel(*args), 20, kernels=(kname,))[0]
        b = bound(0.0, moved[name])
        print(f"{key}: kernel {ms:.4f} ms (host hidden {ms_text(queued)}, "
              f"device {ms_text(dev_ms)}), chain {plain_ms:.4f} ms, bound "
              f"{b[0]:.6f} ms by {b[1]} ({moved[name]} bytes; "
              f"{share_text(b[0], dev_ms)} of it on the device, "
              f"{share_text(b[0], queued)} host hidden)")
        records.append(kernel_record(key, src, replaces[name], 1, 0.0, ms,
                                     plain_ms, b, device_ms=dev_ms))
    clock.done("6d (shading kernels timed)")
    return records


def diff_path(dev, clock, card, size=C4_SIZE, armadillo_faces=C4_ARMADILLO,
              f16_faces=C4_F16, c4=None):
    """Phases 7-13: config 4's progressive step and grad step through
    kernels C, H and G (``c4``: the scene of `config4_scene`, built here
    when None).  Returns the three kernels' JSON records."""
    import numpy as np
    import torch

    from raytracercuda_torch.diff import render_grad, scatter
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import sweep
    from raytracercuda_torch.trace.progressive import (init_progressive,
                                                       progressive_step)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # 7. The config-4 scene.
    if c4 is None:
        c4 = config4_scene(dev, armadillo_faces, f16_faces)
    config, data, accel, eye, orient = c4
    n = size * size
    hw = (size, size)
    print(f"config 4: {data.num_faces} faces -> {accel.num_clusters} "
          f"clusters, {size}x{size}, eye {eye.tolist()}")
    clock.done("7 (scene)")

    # 8. Progressive step, shadows on: warm-up, then three steps.
    def prog(state):
        return progressive_step(state, data, accel, eye, orient, size, size,
                                config, with_shadows=True)

    with torch.no_grad():
        state = prog(init_progressive(n, device=dev))
        sync()
        rec_prog = Recorder(sweep, ["_primary_cuda", "_occlusion_rows_cuda"])
        try:
            sweep.reset_launch_counts()
            for _ in range(3):
                state = prog(state)
            sync()
            prog_launches = dict(sweep.launch_counts)
        finally:
            rec_prog.restore()
    print(f"progressive launches: {prog_launches}")
    check(prog_launches["primary"] > 0, "kernel C never launched")
    check(prog_launches["occlusion_rows"] > 0, "kernel H never launched")
    staged_counts(prog_launches, "progressive")
    img = state.image
    check(tuple(img.shape) == (n, 3) and bool(torch.isfinite(img).all()),
          f"progressive image {tuple(img.shape)} not finite")
    check(state.count == 4, f"progressive count {state.count}")
    clock.done("8 (progressive step)")

    # 9. Grad step (config 4's, :140-150): zero target, no shadows.
    rays = camera_ray_grid(size, size, device=dev)
    zero = torch.zeros((n, 3), device=dev)

    def grad_step(textures=None, target=zero, with_shadows=False):
        p = data.positions.detach().clone().requires_grad_()
        t = (data.textures if textures is None else textures).detach() \
            .clone().requires_grad_()
        loss = render_grad.l2_image_loss(
            data._replace(positions=p, textures=t), accel, rays, eye, orient,
            target, config, frame_hw=hw, with_shadows=with_shadows)
        loss.backward()
        return loss.detach(), p.grad, t.grad

    grad_step()  # warm-up
    sync()
    rec_grad = Recorder(scatter, ["_scatter_add_cuda"])
    rec_grad_c = Recorder(sweep, ["_primary_cuda"])
    try:
        sweep.reset_launch_counts()
        scatter.reset_launch_counts()
        loss, gp, gt = grad_step()
        sync()
        grad_launches = {**sweep.launch_counts, **scatter.launch_counts}
    finally:
        rec_grad.restore()
        rec_grad_c.restore()
    print(f"grad step launches: {grad_launches}; loss {float(loss):.6g}")
    check(grad_launches["scatter_add"] >= 2,
          "kernel G launched fewer than twice in a backward")
    check(grad_launches["primary"] > 0, "kernel C never launched")
    staged_counts(grad_launches, "grad step")
    flags = {"grad_pos_finite": bool(torch.isfinite(gp).all()),
             "grad_pos_nonzero": bool((gp != 0).any()),
             "grad_tex_finite": bool(torch.isfinite(gt).all()),
             "grad_tex_nonzero": bool((gt != 0).any())}
    print(f"grad flags: {flags}")
    check(all(flags.values()), f"grad step flags {flags}")
    clock.done("9 (grad step)")

    # 10. C, H and G against their plain versions on phases 8-9's inputs
    # (the last progressive step's C and H, the grad step's two G calls).
    c_args = rec_prog.calls["_primary_cuda"][-1]
    h_args = rec_prog.calls["_occlusion_rows_cuda"][-1]
    g_calls = rec_grad.calls["_scatter_add_cuda"]
    c_err = 0.0  # bit-equal, checked below
    for what, args in (("progressive step", c_args),
                       ("grad step", rec_grad_c.calls["_primary_cuda"][-1])):
        kc = staged_rows_check(sweep, "eye", sweep._primary_cuda, args,
                               f"kernel C ({what})")
        pc = sweep._primary_plain(*args)
        sync()
        hits, _ = closest_err(kc, pc, f"kernel C ({what})")
        items, lanes = split_stats(args[0], sweep.PRIMARY_CHUNK,
                                   args[2].shape[1])
        print(f"kernel C ({what}) matches plain bit for bit: {hits} hit "
              f"rays of {pc[0].numel()}; {items} work items at K = "
              f"{sweep.PRIMARY_CHUNK}, {lanes:.2f} active lanes per warp")
    kh = staged_rows_check(sweep, "light", sweep._occlusion_rows_cuda,
                           h_args, "kernel H (progressive step)")
    ph = sweep._occlusion_rows_plain(*h_args)
    sync()
    h_err = occlusion_err(kh, ph, "kernel H")
    h_items, h_lanes = split_stats(h_args[0], sweep.OCCLUSION_ROWS_CHUNK,
                                   h_args[2].shape[1], h_args[3])
    print(f"kernel H matches plain: {int(ph.sum())} occluded of "
          f"{int(h_args[3].sum())} active shadow rays in "
          f"{int(h_args[3].any(dim=1).sum())} tiles; {h_items} work items "
          f"at K = {sweep.OCCLUSION_ROWS_CHUNK}, {h_lanes:.2f} active lanes "
          f"per warp")
    check(int(ph.sum()) > 0, "no shadow ray is occluded")
    h_serial, h_occluded = serial_anyhit_tests(*h_args)
    check(h_occluded == int(ph.sum()), "serial any-hit count: "
          f"{h_occluded} occluded rays, plain {int(ph.sum())}")
    g_err = 0.0
    for args in g_calls:
        kg = scatter._scatter_add_cuda(*args)
        kg2 = scatter._scatter_add_cuda(*args)
        pg = scatter._scatter_add_plain(*args)
        sync()
        err = scatter_err(kg, pg, args[1], args[2],
                          f"kernel G [{tuple(args[0].shape)}]")
        g_err = max(g_err, err)
        print(f"kernel G matches plain, g {tuple(args[0].shape)} -> "
              f"{args[2]} rows: max abs err {err:.3g}, untouched rows 0.0; "
              f"two kernel runs bitwise equal: {torch.equal(kg, kg2)}")
    g_err = max(g_err, scatter_cases(dev))
    clock.done("10 (kernels vs plain)")
    sorted_g_checks(dev, g_calls)
    clock.done("10b (G's sorted route)")
    bundle_checks(dev, data, accel, eye, orient, config)
    clock.done("10c (ray bundles)")
    occlusion_cases(dev, accel, config)
    clock.done("10d (H and B synthetic cases)")

    # 11. The grad step (and a shadowed render) with the plain versions.
    plain = PlainOnCard({
        sweep: {"_primary_cuda": sweep._primary_plain,
                "_occlusion_rows_cuda": sweep._occlusion_rows_plain},
        scatter: {"_scatter_add_cuda": scatter._scatter_add_plain}})

    def discrete():
        return render_grad._discrete(data, accel, rays, eye, orient, config,
                                     "lambert", True, (0.4, 0.8, -0.45), hw)

    def shadowed():
        with torch.no_grad():
            return render_grad.render_rgb(data, accel, rays, eye, orient,
                                          config, with_shadows=True,
                                          frame_hw=hw)

    k_ids, k_mask = discrete()
    k_img = shadowed()
    with plain:
        p_ids, p_mask = discrete()
        p_img = shadowed()
        p_loss, p_gp, p_gt = grad_step()
    sync()
    check(torch.equal(k_ids, p_ids), "plain path: other hit ids")
    check(torch.equal(k_mask, p_mask), "plain path: other shadow mask")
    img_err = float((k_img - p_img).abs().max())
    check(img_err <= 1e-6, f"plain path: image differs by {img_err}")
    # G sums a row's cotangents with float atomics, in an order that
    # changes from run to run; index_add_ in another.  Each gradient entry
    # is a sum of such rows' entries, so the two agree to float32 rounding
    # of those sums: within 1e-4 of the gradient's largest entry.
    for name, k, p_ in (("positions", gp, p_gp), ("textures", gt, p_gt)):
        err = float((k - p_).abs().max())
        bar = 1e-4 * float(p_.abs().max())
        print(f"plain path grad {name}: max abs diff {err:.3g} (bar "
              f"{bar:.3g})")
        check(err <= bar, f"plain path grad {name}: {err} > {bar}")
    print(f"plain path: equal ids and masks, image max abs diff "
          f"{img_err:.3g}, loss {float(p_loss):.6g} vs {float(loss):.6g}")
    clock.done("11 (plain grad step)")

    # 12. Five Adam steps from a perturbed texture toward the true one.
    target = shadowed()
    rng = np.random.default_rng(5)
    noise = torch.from_numpy(rng.normal(
        0.0, 0.5, tuple(data.textures.shape)).astype(np.float32)).to(dev)
    params = [data.positions.detach().clone().requires_grad_(),
              (data.textures + noise).clamp(0.0, 1.0).requires_grad_()]
    opt = torch.optim.Adam(params, lr=1e-2)

    def fit_loss():
        return render_grad.l2_image_loss(
            data._replace(positions=params[0], textures=params[1]), accel,
            rays, eye, orient, target, config, frame_hw=hw,
            with_shadows=True)

    losses = []
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        loss = fit_loss()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        losses.append(float(fit_loss()))  # after the last step
    print(f"adam losses (before each step, then after the last): {losses}")
    check(all(np.isfinite(losses)), "adam: loss not finite")
    check(losses[-1] < losses[0], "adam: the loss did not fall")
    clock.done("12 (adam)")

    # 13. Timing.
    print(f"timing on {card}")
    with torch.no_grad():
        state = init_progressive(n, device=dev)
        prog_ms = time_cuda(lambda: prog(state), 5)
        with plain:
            prog_plain_ms = time_cuda(lambda: prog(state), 2)
    grad_ms = time_cuda(grad_step, 5)
    with plain:
        grad_plain_ms = time_cuda(grad_step, 2)
    def kernel_c():
        return sweep._primary_cuda(*c_args)

    def kernel_h():
        return sweep._occlusion_rows_cuda(*h_args)

    times = {
        "C": (time_cuda(kernel_c, 20),
              time_cuda(lambda: sweep._primary_plain(*c_args), 3)),
        "H": (time_cuda(kernel_h, 20),
              time_cuda(lambda: sweep._occlusion_rows_plain(*h_args), 3)),
    }
    c_device_ms, c_glue_ms = device_ms(kernel_c, 20, SPLIT_KERNELS)[:2]
    c_queued_ms = time_queued(kernel_c, 10)
    print(f"kernel C: {times['C'][0]:.4f} ms per launch, device (both "
          f"passes and the key fill) {ms_text(c_device_ms)}, the split's "
          f"PyTorch kernels {ms_text(c_glue_ms)}, host hidden "
          f"{ms_text(c_queued_ms)}")
    c_k = k_sweep(sweep, "PRIMARY_CHUNK", (1, 2, 4, 8, 16), kernel_c, 20,
                  c_args[0], c_args[2].shape[1])
    print(f"kernel C by K ({K_SWEEP_FIELDS}): {c_k}")
    h_device_ms, h_glue_ms = device_ms(kernel_h, 20, SPLIT_KERNELS)[:2]
    h_queued_ms = time_queued(kernel_h, 10)
    print(f"kernel H: {times['H'][0]:.4f} ms per launch, device (the flag "
          f"clear and the pass) {ms_text(h_device_ms)}, the split's PyTorch "
          f"kernels {ms_text(h_glue_ms)}, host hidden {ms_text(h_queued_ms)}")
    h_k = k_sweep(sweep, "OCCLUSION_ROWS_CHUNK", (1, 2, 4, 8, 16, 32),
                  kernel_h, 20, h_args[0], h_args[2].shape[1], h_args[3])
    print(f"kernel H by K ({K_SWEEP_FIELDS}): {h_k}")
    # G and its yardsticks on each of the backward's calls: event time and
    # profiler device time.  `index_add_` alone (the one PyTorch call, on
    # an output zeroed once, which accumulates over the calls) and
    # `torch.zeros` + `index_add_` (the same function as G) on the same
    # kept rows and ids, their layout made outside the timing.
    g_rows = []
    for g, idx, rows in g_calls:
        d = g.shape[1]
        flat = idx.reshape(-1).long()
        keep = (flat >= 0) & (flat < rows)
        src_rows = g.transpose(1, 2).reshape(-1, d)[keep].contiguous()
        flat = flat[keep].contiguous()
        acc = torch.zeros((rows, d), dtype=torch.float32, device=dev)

        def kernel(a=(g, idx, rows)):
            return scatter._scatter_add_cuda(*a)

        def ordered(a=(g, idx, rows)):
            return scatter._scatter_add_cuda(*a, overlap=False)

        def library(acc=acc, flat=flat, src_rows=src_rows):
            return acc.index_add_(0, flat, src_rows)

        def zeroed(rows=rows, d=d, flat=flat, src_rows=src_rows):
            return torch.zeros((rows, d), dtype=torch.float32,
                               device=dev).index_add_(0, flat, src_rows)

        split = device_activities(kernel, 20)
        r = {"ms": time_cuda(kernel, 20),
             "device_ms": sum(ms for ms, _ in split.values()) or None,
             "queued_ms": time_queued(kernel, 20),
             "ordered_ms": time_cuda(ordered, 20),
             "ordered_queued_ms": time_queued(ordered, 20),
             "plain_ms": time_cuda(lambda a=(g, idx, rows):
                                   scatter._scatter_add_plain(*a), 20),
             "library_ms": time_cuda(library, 20),
             "library_device_ms": device_ms(library, 20)[0],
             "library_queued_ms": time_queued(library, 20),
             "library_zeroed_ms": time_cuda(zeroed, 20),
             "library_zeroed_device_ms": device_ms(zeroed, 20)[0],
             "library_zeroed_queued_ms": time_queued(zeroed, 20),
             "kept": int(keep.sum())}
        # The cotangents of dropped ids (misses) need not be read.
        r["bound"] = bound(r["kept"] * d, 4 * r["kept"] * d + nbytes(idx)
                           + 4 * rows * d)
        g_rows.append(r)
        print(f"kernel G, g {tuple(g.shape)} -> {rows} rows of {d} "
              f"({r['kept']} kept rays, atomic width "
              f"{scatter._atomic_width(d)}), bound {r['bound'][0]:.6f} ms:")
        parts = "".join(f", {short_kernel_name(name)} {ms:.4f}"
                        for name, (ms, _) in split.items())
        print(f"  G {r['ms']:.4f} ms, device {ms_text(r['device_ms'])}"
              f"{parts}; host hidden {ms_text(r['queued_ms'])}; in stream "
              f"order (no PDL) {r['ordered_ms']:.4f} ms, host hidden "
              f"{ms_text(r['ordered_queued_ms'])}; plain "
              f"{r['plain_ms']:.4f} ms")
        for name, key in (("index_add_", "library"),
                          ("zeros + index_add_", "library_zeroed")):
            print(f"  {name} {r[key + '_ms']:.4f} ms, device "
                  f"{ms_text(r[key + '_device_ms'])}, host hidden "
                  f"{ms_text(r[key + '_queued_ms'])}")

    def g_mean(key):
        vals = [r[key] for r in g_rows]
        return None if None in vals else sum(vals) / len(vals)

    # G's record: the mean of the backward's launches.
    times["G"] = (g_mean("ms"), g_mean("plain_ms"))
    with torch.no_grad():
        prog_device_ms = device_ms(lambda: prog(state), 5)[0]
    grad_device_ms = device_ms(grad_step, 5)[0]
    print(f"progressive step ({size}x{size}, shadows): kernel path "
          f"{prog_ms:.4f} ms (device {ms_text(prog_device_ms)}), plain path "
          f"{prog_plain_ms:.4f} ms")
    print(f"grad step ({size}x{size}): kernel path {grad_ms:.4f} ms (device "
          f"{ms_text(grad_device_ms)}), plain path {grad_plain_ms:.4f} ms")
    for name, (ms, pms) in times.items():
        print(f"kernel {name}: {ms:.4f} ms per launch (plain {pms:.4f} ms)")
    clock.done("13 (timing)")

    # Bounds on these inputs (G's above).
    c_tests = sweep_tests(c_args[0], c_args[2].shape[1], c_args[3].shape[1])
    c_bound = bound(c_tests * MT_OPS, nbytes(c_args, kernel_c()))
    h_tests = sweep_tests(h_args[0], h_args[2].shape[1], h_args[4].shape[1],
                          active=h_args[3], occluded=ph)
    h_bound = bound(h_tests * MT_OPS, nbytes(h_args) + 4 * ph.numel())
    print(f"kernel C: {c_tests} ray-triangle tests; kernel H: {h_tests} "
          f"(rays that find no hit test their whole list, an occluded ray "
          f"one test), {h_serial} in a serial early-exit sweep (an occluded "
          f"ray to its first hit)")
    g_bound = (sum(r["bound"][0] for r in g_rows) / len(g_rows),
               g_rows[0]["bound"][1])
    src = "raytracercuda_torch/csrc/sweep.cu"
    return [
        kernel_record("primary", src,
                      "raytracercuda_tpu/trace/pallas_sweep.py:118",
                      prog_launches["primary"] + grad_launches["primary"],
                      c_err, *times["C"], c_bound, device_ms=c_device_ms),
        kernel_record("occlusion_rows", src,
                      "raytracercuda_tpu/trace/pallas_sweep.py:201",
                      prog_launches["occlusion_rows"]
                      + grad_launches["occlusion_rows"],
                      h_err, *times["H"], h_bound,
                      device_ms=h_device_ms),
        kernel_record("scatter_add", "raytracercuda_torch/csrc/scatter.cu",
                      "raytracercuda_tpu/diff/scatter.py:52",
                      grad_launches["scatter_add"], g_err, *times["G"],
                      g_bound, g_mean("library_ms"),
                      device_ms=g_mean("device_ms"),
                      library_device_ms=g_mean("library_device_ms"),
                      library_zeroed_ms=g_mean("library_zeroed_ms")),
    ]


def serial_anyhit_tests(lists, light, o_tiles, active, blocks, t_eps):
    """Ray-triangle tests a serial early-exit any-hit sweep (the old kernel
    H's) runs on kernel H's inputs: each active ray that finds no hit its
    whole list, each occluded one the list position of its first hit plus
    one, from the plain version's tests rank by rank.  Returns (tests,
    occluded rays)."""
    import torch

    from raytracercuda_torch.trace import sweep
    from raytracercuda_torch.types import FLT_MAX

    g = blocks.shape[1]
    counts = lists.counts
    first = torch.full(active.shape, -1, dtype=torch.long,
                       device=active.device)
    o = o_tiles.transpose(1, 2)[:, :, None, :]  # [T,3,1,R]
    for r in range(int(counts.max()) if counts.numel() else 0):
        for tiles in (counts > r).nonzero()[:, 0].split(256):
            blk = blocks[lists.ids[lists.offsets[tiles].long() + r].long()]
            ot = o[tiles]
            t, _, _ = sweep._mt_cols(tuple(blk[:, :, k:k + 1]
                                           for k in range(9)),
                                     ot[:, 0], ot[:, 1], ot[:, 2], light[0],
                                     light[1], light[2], t_eps)
            hit = t < FLT_MAX  # [n, G, R]
            j = hit.int().argmax(dim=1)  # the first slot with a hit
            new = hit.any(dim=1) & (first[tiles] < 0)
            first[tiles] = torch.where(new, r * g + j, first[tiles])
    occluded = active & (first >= 0)
    free = active & (first < 0)
    tests = int((counts.long() * free.sum(dim=1)).sum()) * g \
        + int((first[occluded] + 1).sum())
    return tests, int(occluded.sum())


def kernel_usage(log: str) -> dict:
    """Each kernel's ``ptxas -v`` usage line from the build's output:
    ``{name<template args>: "Used N registers, ..."}``."""
    import re

    used, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)((?:I(?:L[bi]\w+?E)+E)?)",
                          m.group(1))
            args = re.findall(r"L([bi])(\w+?)E", k.group(2)) if k else []
            name = (k.group(1) + (
                "<" + ", ".join(("true" if v == "1" else "false")
                                if t == "b" else v for t, v in args) + ">"
                if args else "")) if k else m.group(1)
        if "Used " in line and name:
            used[name] = line
            name = None
    return used


def kernel_registers(log: str) -> dict:
    """Registers per thread of each kernel (`kernel_usage`):
    ``{name<template args>: registers}``."""
    import re

    return {k: int(re.search(r"Used (\d+) registers", v).group(1))
            for k, v in kernel_usage(log).items()}


def kernel_shared(log: str) -> dict:
    """Static shared memory a block of each kernel (`kernel_usage`), in
    bytes (0 where ptxas prints none)."""
    import re

    return {k: int(m.group(1)) if (m := re.search(r"(\d+) bytes smem", v))
            else 0 for k, v in kernel_usage(log).items()}


#: What each entry of a `k_sweep` holds.
K_SWEEP_FIELDS = ("events ms per launch, device ms (the C entry's kernels), "
                  "work items, active lanes per warp")


def k_sweep(sweep, name: str, ks, fn, iters: int, lists, rays_per_tile,
            active=None) -> dict:
    """``fn`` with `sweep`'s chunk constant ``name`` (K) at each of ``ks``:
    its event time and its device time (`device_ms`; None when the
    profiler records nothing), both ms per call, with the work items and
    active lanes per warp; the constant is put back.  K changes what the
    card does, so the device time is the one that chooses it."""
    keep = getattr(sweep, name)
    out = {}
    try:
        for k in ks:
            setattr(sweep, name, k)
            items, lanes = split_stats(lists, k, rays_per_tile, active)
            dev_ms, _, _ = device_ms(fn, iters, SPLIT_KERNELS)
            out[k] = (round(time_cuda(fn, iters), 4),
                      None if dev_ms is None else round(dev_ms, 4),
                      items, round(lanes, 2))
    finally:
        setattr(sweep, name, keep)
    return out


def split_chunk_report(sweep, where: str, kernel_a, kernel_b, a_args,
                       b_args, iters: int) -> tuple:
    """Kernels A and B on one frame's inputs: their device times (the C
    entries' kernels, and the work-item split's PyTorch kernels apart),
    and their event and device times at K = 1 to 16 clusters per work
    item.  Returns A's and B's device times."""
    out = []
    for name, fn, const, ks, args, active in (
            ("A", kernel_a, "SHADE_CHUNK", (1, 2, 4, 8, 16), a_args, None),
            ("B", kernel_b, "OCCLUSION_CHUNK", (1, 2, 4, 8, 16), b_args,
             b_args[3])):
        a_ms, glue_ms, _ = device_ms(fn, iters, SPLIT_KERNELS)
        by_k = k_sweep(sweep, const, ks, fn, iters, args[0],
                       args[2].shape[2], active)
        print(f"kernel {name} ({where}): device (its C entry's kernels) "
              f"{ms_text(a_ms)}, the split's PyTorch kernels "
              f"{ms_text(glue_ms)}; by K ({K_SWEEP_FIELDS}): {by_k}")
        out.append(a_ms)
    return tuple(out)


def sorted_g_checks(dev, g_calls) -> None:
    """G's sorted route (`torch.use_deterministic_algorithms(True)`) on the
    grad step's calls and on `G_CASES`: two runs bitwise equal, and equal
    to the plain version run on the CPU from the same inputs; its time
    beside the atomic route's."""
    import numpy as np
    import torch

    from raytracercuda_torch.diff import scatter

    cases = [(f"grad step call {i + 1}", args) for i, args in
             enumerate(g_calls)]
    for name, (t, b, d, rows, lo, hi, equal) in G_CASES.items():
        rng = np.random.default_rng(sorted(G_CASES).index(name))
        ids = rng.integers(lo, hi, (t, b))
        if equal:
            ids[0, 32:64] = 5
            ids[1, :] = rows - 1
        cases.append((name, (torch.from_numpy(rng.normal(size=(t, d, b))
                                              .astype(np.float32)).to(dev),
                             torch.from_numpy(ids.astype(np.int32)).to(dev),
                             rows)))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for name, args in cases:
            scatter.reset_launch_counts()
            k1 = scatter.tile_scatter_add(*args)
            k2 = scatter.tile_scatter_add(*args)
            sync_device(dev)
            check(scatter.launch_counts == {"scatter_add": 0,
                                            "scatter_sorted": 2},
                  f"G's sorted route: launches {scatter.launch_counts}")
            check(bits_equal(k1, k2), f"G's sorted route ({name}): two runs "
                  "differ")
            p = scatter._scatter_add_plain(args[0].cpu(), args[1].cpu(),
                                           args[2])
            check(bits_equal(k1.cpu(), p), f"G's sorted route ({name}): not "
                  f"bitwise equal to the plain version on the CPU")
            line = (f"G's sorted route ({name}, g {tuple(args[0].shape)} -> "
                    f"{args[2]} rows): two runs bitwise equal, and equal to "
                    f"the plain version on the CPU")
            if name.startswith("grad"):
                ms = time_cuda(lambda a=args: scatter.tile_scatter_add(*a), 20)
                line += f"; {ms:.4f} ms a call"
            print(line)
    finally:
        torch.use_deterministic_algorithms(was)
    for name, args in cases[:len(g_calls)]:
        ms = time_cuda(lambda a=args: scatter.tile_scatter_add(*a), 20)
        print(f"G's atomic route ({name}): {ms:.4f} ms a call")


def scattered_bundle(dev, lo, hi, n: int, seed: int):
    """``n`` rays from points on a sphere around the box ``[lo, hi]``
    toward points inside it (directions of length 0.5 to 2): a bundle with
    no shared origin and no order."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = lo.cpu().numpy(), hi.cpu().numpy()
    around = rng.normal(size=(n, 3))
    origins = (lo + hi) / 2 + float(np.linalg.norm(hi - lo)) * around \
        / np.linalg.norm(around, axis=1, keepdims=True)
    d = lo + rng.random((n, 3)) * (hi - lo) - origins
    d *= rng.uniform(0.5, 2.0, (n, 1)) / np.linalg.norm(d, axis=1,
                                                         keepdims=True)
    return (torch.from_numpy(origins.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev))


def bundle_checks(dev, data, accel, eye, orient, config,
                  size: int = BUNDLE_SIZE, scattered: int = BUNDLE_RAYS):
    """Phase 10c: CLUSTER ray bundles that are not a pinhole frame, on the
    card against the same calls on the plain versions: `render_rgb`
    without ``frame_hw`` at ``size``² with shadows (C's epilogue over F's
    sweep, then H; equal ids, masks and images), and `trace_hit` on
    ``scattered`` rays with scattered origins (equal faces, t/u/v
    bit-equal)."""
    import torch

    from raytracercuda_torch.diff import render_grad
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import bounce_sweep, sweep
    from raytracercuda_torch.trace.pipeline import trace_hit

    rays = camera_ray_grid(size, size, device=dev)
    origins, dirs = scattered_bundle(dev, data.positions.amin(dim=0),
                                     data.positions.amax(dim=0), scattered,
                                     seed=6)

    def run():
        with torch.no_grad():
            ids, mask = render_grad._discrete(
                data, accel, rays, eye, orient, config, "lambert", True,
                (0.4, 0.8, -0.45), None)
            img = render_grad.render_rgb(data, accel, rays, eye, orient,
                                         config, with_shadows=True)
            return ids, mask, img, trace_hit(data, accel, origins, dirs,
                                             config)

    sweep.reset_launch_counts()
    rec = Recorder(sweep, ["_occlusion_rows_cuda"])
    try:
        k_ids, k_mask, k_img, k_hit = run()
        sync_device(dev)
    finally:
        rec.restore()
    launches = dict(sweep.launch_counts)
    check(launches["closest_rays"] >= 3 and launches["occlusion_rows"] >= 2,
          f"ray bundles: launches {launches}")
    staged_counts(launches, "ray bundles")
    check(launches["eye_rows"] == 0, f"ray bundles: F's sweep staged eye "
          f"rows: {launches}")
    h_args = rec.calls["_occlusion_rows_cuda"][-1]
    occlusion_err(staged_rows_check(sweep, "light",
                                    sweep._occlusion_rows_cuda, h_args,
                                    "kernel H (ray bundles)"),
                  sweep._occlusion_rows_plain(*h_args),
                  "kernel H (ray bundles)")
    with PlainOnCard({
            bounce_sweep: {"_closest_rays_cuda": sweep._closest_rays_plain},
            sweep: {"_occlusion_rows_cuda": sweep._occlusion_rows_plain}}):
        p_ids, p_mask, p_img, p_hit = run()
    sync_device(dev)
    check(torch.equal(k_ids, p_ids), "ray bundles: other hit ids than plain")
    check(torch.equal(k_mask, p_mask), "ray bundles: other shadow mask")
    check(bits_equal(k_img, p_img), "ray bundles: image differs from plain")
    check(torch.equal(k_hit.face, p_hit.face),
          "scattered bundle: faces differ from plain")
    for name in ("t", "u", "v"):
        check(bits_equal(getattr(k_hit, name), getattr(p_hit, name)),
              f"scattered bundle: {name} not bit-equal to plain")
    hit = k_ids >= 0
    check(0 < int(hit.sum()) and int(k_mask.sum()) > 0
          and int((k_hit.face >= 0).sum()) > 0,
          "ray bundles: nothing hit or shadowed")
    print(f"ray bundles match plain: render_rgb without frame_hw at "
          f"{size}x{size} ({int(hit.sum())} hits, {int(k_mask.sum())} "
          f"shadowed, image bit-equal); trace_hit on {scattered} scattered "
          f"rays ({int((k_hit.face >= 0).sum())} hits, t/u/v bit-equal); "
          f"launches {launches}")


def occlusion_cases(dev, accel, config) -> None:
    """Phase 10d: kernels H and B (B on the same origins, planar) on
    synthetic inputs over config 4's clusters, held against their plain
    version (masks equal) at K = 1, the default and 32: a tile that
    lists every cluster with 255 rays inside the armadillo stand-in and
    one free ray, beside a tile with no active ray; rays that only a
    triangle of their list's last cluster (the last work item) occludes;
    9x9 tiles (R = 81, not a multiple of 32) over random lists."""
    import numpy as np
    import torch

    from raytracercuda_torch.trace import sweep

    rng = np.random.default_rng(12)
    geom = sweep.segment_blocks(accel)
    c, g = geom.shape[0], geom.shape[1]
    t_eps = np.float32(config.trace.t_epsilon)
    light = torch.nn.functional.normalize(
        torch.tensor([0.4, 0.8, -0.45], device=dev), dim=0)
    centre = np.array([0.0, -1.0, 14.0], np.float32)  # the armadillo's

    def tensor(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    def lists_of(survive):
        return sweep._tile_lists(tensor(survive, torch.bool))

    every = np.ones((1, c), bool)
    cases = {}
    # 255 origins within 2 of the centre (the shell lies 3.4-4.6 out), and
    # one far out along the light; the second tile's rays are inactive.
    inside = centre + rng.normal(size=(2, 256, 3)) * 0.6
    inside[0, 100] = centre + 1000.0 * light.cpu().numpy()
    act = np.zeros((2, 256), bool)
    act[0] = True
    cases["every_cluster_one_free"] = (lists_of(np.concatenate([every,
                                                                every])),
                                       tensor(inside), tensor(act, torch.bool))
    # Points on real triangles of the last cluster, backed off along the
    # light by 1e-2: each ray crosses its triangle at t = 1e-2.  Kept: the
    # rays that the list without the last cluster leaves free.
    slots = ((accel.face_order >= 0).nonzero()[:, 0]).cpu().numpy()
    last = slots[slots >= (c - 1) * g]
    tris = accel.tris.reshape(-1, 3, 3)[tensor(rng.choice(last, 256),
                                               torch.long)]
    w = tensor(rng.dirichlet((1.0, 1.0, 1.0), 256))
    on = (tris * w[:, :, None]).sum(dim=1)
    best = None
    for sign in (1.0, -1.0):
        ray_dir = light * sign
        o = (on - 1e-2 * ray_dir)[None].contiguous()
        all_act = torch.ones((1, 256), dtype=torch.bool, device=dev)
        full = sweep._occlusion_rows_plain(lists_of(every), ray_dir, o,
                                           all_act, geom, t_eps)
        cut = every.copy()
        cut[0, -1] = False
        rest = sweep._occlusion_rows_plain(lists_of(cut), ray_dir, o,
                                           all_act, geom, t_eps)
        only = full & ~rest
        if best is None or int(only.sum()) > int(best[2].sum()):
            best = (ray_dir, o, only)
    check(int(best[2].sum()) >= 32, f"last_item_only: {int(best[2].sum())} "
          "rays occluded by the last cluster alone")
    cases["last_item_only"] = (lists_of(every), best[1], best[2],
                               best[0].contiguous())
    # Six 9x9 tiles over random ascending lists, origins in the scene's
    # box, 70% active.
    lo = accel.tris.reshape(-1, 3).amin(dim=0).cpu().numpy()
    hi = accel.tris.reshape(-1, 3).amax(dim=0).cpu().numpy()
    cases["ragged_9x9"] = (lists_of(rng.random((6, c)) < 0.3),
                           tensor(lo + rng.random((6, 81, 3)) * (hi - lo)),
                           tensor(rng.random((6, 81)) < 0.7, torch.bool))
    keep = (sweep.OCCLUSION_CHUNK, sweep.OCCLUSION_ROWS_CHUNK)
    ks = sorted({1, *keep, 32})
    try:
        for name, (lst, o, act, *l_dir) in cases.items():
            ld = l_dir[0] if l_dir else light
            args = (lst, ld, o, act, geom, t_eps)
            planar = (lst, ld, o.transpose(1, 2).contiguous(), act, geom,
                      t_eps)
            p = sweep._occlusion_rows_plain(*args)
            for k in ks:
                sweep.OCCLUSION_CHUNK = sweep.OCCLUSION_ROWS_CHUNK = k
                occlusion_err(sweep._occlusion_rows_cuda(*args), p,
                              f"kernel H ({name}, K = {k})")
                occlusion_err(sweep._occlusion_cuda(*planar), p,
                              f"kernel B ({name}, K = {k})")
            sweep.OCCLUSION_CHUNK, sweep.OCCLUSION_ROWS_CHUNK = keep
            if name == "every_cluster_one_free":
                check(not bool(p[0, 100]) and int(p[0].sum()) >= 250
                      and not bool(p[1].any()),
                      f"{name}: {int(p[0].sum())} occluded in tile 0")
            if name == "last_item_only":
                check(bool(p[act].all()), f"{name}: a kept ray is free")
            items, lanes = split_stats(lst, keep[1], o.shape[1], act)
            print(f"kernel H case {name}: {int(p.sum())} occluded of "
                  f"{int(act.sum())} active rays, R = {o.shape[1]}, "
                  f"{int(lst.counts.max())} clusters in the longest list, "
                  f"{items} work items at H's K = {keep[1]}; H and B "
                  f"(planar origins) equal to plain at K = {ks}")
    finally:
        sweep.OCCLUSION_CHUNK, sweep.OCCLUSION_ROWS_CHUNK = keep


def config2_scene(dev, size, suzanne_faces, default_structure=False,
                  accel=None):
    """Config 2's scene through the public API (scripts/bench_configs.py:
    79-102): BRUTE, or the structure ``accel`` names (or, with
    ``default_structure``, `Scene.create()` with no config), the suzanne
    stand-in ``bumpy_sphere_mesh`` at the origin
    (radius 1) and the reference's quad at z = 2.5, a ``size`` square
    `Camera` and locked `RenderTarget`, eye (0, 0, -2.1).  Returns
    ``(scene, camera, target, eye, orient)``."""
    import numpy as np

    import raytracercuda_torch as rt
    from raytracercuda_torch.models.procedural import (bumpy_sphere_mesh,
                                                       quad_mesh)

    scene = (rt.Scene.create(device=dev) if default_structure else
             rt.Scene.create(rt.RenderConfig(
                 accel=accel or rt.AccelKind.BRUTE), device=dev))
    scene.add_mesh(bumpy_sphere_mesh(suzanne_faces, radius=1.0,
                                     center=(0.0, 0.0, 0.0)))
    scene.add_mesh(quad_mesh(z=2.5))
    cam = rt.Camera.create(dev)
    check(cam.set_initial_rays(size, size, -1, 1, -1, 1, 1) == 0,
          "set_initial_rays failed")
    target = rt.RenderTarget.create(size, size, dev)
    check(target.lock() == 0, "lock failed")
    eye = np.array([0.0, 0.0, -2.1], np.float32)
    return scene, cam, target, eye, rt.orient_from_pan_pitch(0.0, 0.0)


def api_path(dev, clock, card, size=C2_SIZE, suzanne_faces=C2_SUZANNE):
    """Phases 14-16: config 2's frame through the public API, kernels D
    and E.  Returns their figures for the kernels line, by name."""
    import torch

    import raytracercuda_torch as rt
    from raytracercuda_torch.ops import clear
    from raytracercuda_torch.trace import bruteforce

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # 14. The scene, camera and target, as bench_configs.config2 makes them.
    scene, cam, target, eye, orient = config2_scene(dev, size, suzanne_faces)
    print(f"config 2: {scene.data().num_faces} faces, BRUTE, {size}x{size}")
    check(cam.trace_scene(eye, orient, scene, target) == 0, "warm-up frame")
    sync()
    clock.done("14 (config 2 scene)")

    # 15. The main path: clear (D), then trace (E).
    n = size * size
    rec = Recorder(bruteforce, ["_brute_cuda"])
    try:
        clear.reset_launch_counts()
        bruteforce.reset_launch_counts()
        err_clear = cam.clear(target, CLEAR_VALUE)
        cleared = target.buffer.clone()
        frame_bits(cleared, "config 2 Camera.clear")
        err = cam.trace_scene(eye, orient, scene, target)
        sync()
        launches = {**clear.launch_counts, **bruteforce.launch_counts}
    finally:
        rec.restore()
    print(f"config 2 launches: {launches}")
    check(err_clear == 0 and err == 0, f"clear {err_clear}, trace {err}")
    check(launches["clear"] > 0, "kernel D never launched")
    check(launches["brute"] > 0, "kernel E never launched")
    full = torch.full((n,), CLEAR_VALUE, dtype=torch.uint32, device=dev)
    check(torch.equal(cleared, full), "kernel D: buffer differs from "
          "torch.full")
    frame = target.buffer.clone()
    frame_bits(frame, "config 2 frame")
    miss = 255 << 8
    hit_share = float((frame != miss).float().mean())
    print(f"config 2 frame: hit share {hit_share:.4f}")
    check(0.0 < hit_share < 1.0, f"hit share {hit_share}")
    clock.done("15 (config 2 frame)")

    # 16. E and D against their plain versions; the plain-path frame; the
    # misuse cases' codes; timing.
    e_args = rec.calls["_brute_cuda"][-1]
    ke = bruteforce._brute_cuda(*e_args)
    pe = bruteforce._brute_plain(*e_args)
    sync()
    check(torch.equal(ke[3], pe[3]), "kernel E: faces differ from plain: "
          f"{int((ke[3] != pe[3]).sum())} rays")
    for k, name in enumerate("tuv"):
        check(bits_equal(ke[k], pe[k]), f"kernel E: {name} not bit-equal")
    e_err = 0.0  # bit-equal, checked above
    print(f"kernel E matches plain bit for bit: {int((pe[3] >= 0).sum())} "
          f"hit rays of {pe[3].numel()}; {e_args[2].shape[1]} faces, P = "
          f"{bruteforce.BRUTE_RAYS_PER_THREAD}, face chunk "
          f"{bruteforce.BRUTE_FACE_CHUNK}")
    kd = clear._clear_cuda(n, CLEAR_VALUE, dev)
    pd = clear._clear_plain(n, CLEAR_VALUE, dev)
    check(torch.equal(kd, pd), "kernel D differs from its plain version")
    for m in CLEAR_SIZES:
        check(torch.equal(clear._clear_cuda(m, CLEAR_VALUE, dev),
                          torch.full((m,), CLEAR_VALUE, dtype=torch.uint32,
                                     device=dev)),
              f"kernel D differs from torch.full at {m} pixels")
    print(f"kernel D equals torch.full at {list(CLEAR_SIZES)} pixels")
    plain = PlainOnCard({bruteforce: {"_brute_cuda": bruteforce._brute_plain},
                         clear: {"_clear_cuda": clear._clear_plain}})
    plain_target = rt.RenderTarget.create(size, size, dev)
    with plain:
        check(cam.clear(plain_target, CLEAR_VALUE) == 0, "plain clear")
        check(cam.trace_scene(eye, orient, scene, plain_target) == 0,
              "plain frame")
        sync()
        plain_frame_ms = time_cuda(
            lambda: cam.trace_scene(eye, orient, scene, plain_target), 3)
    check(torch.equal(plain_target.buffer, frame),
          "config 2: the plain-path frame differs")
    print("config 2 frame equals the plain-path frame")
    codes = {
        "no_render_target": cam.trace_scene(eye, orient, scene, None),
        "size_mismatch": cam.trace_scene(
            eye, orient, scene, rt.RenderTarget.create(2 * size, size, dev)),
        "camera_without_rays": rt.Camera.create(dev).trace_scene(
            eye, orient, scene, target),
        "no_scene": cam.trace_scene(eye, orient, None, target),
        "clear_without_target": cam.clear(None, 0),
        "zero_width": rt.Camera.create(dev).set_initial_rays(0, size),
        "lock_twice": target.lock(),
        "unlock": target.unlock(),
        "unlock_twice": target.unlock(),
    }
    print(f"config 2 misuse codes: {codes}")
    want = {"no_render_target": 8, "size_mismatch": 5,
            "camera_without_rays": 2, "no_scene": 2,
            "clear_without_target": 8, "zero_width": 2, "lock_twice": 6,
            "unlock": 0, "unlock_twice": 7}
    check(codes == want, f"misuse codes {codes}, want {want}")

    brute_cases(dev)
    clock.done("16b (E synthetic cases)")

    print(f"timing on {card}")
    frame_ms = time_cuda(lambda: cam.trace_scene(eye, orient, scene, target),
                         20)

    def kernel_e():
        return bruteforce._brute_cuda(*e_args)

    e_ms = time_cuda(kernel_e, 20)
    e_plain_ms = time_cuda(lambda: bruteforce._brute_plain(*e_args), 3)
    e_device_ms, e_glue_ms = device_ms(kernel_e, 20, SPLIT_KERNELS)[:2]
    e_queued_ms = time_queued(kernel_e, 10)
    print(f"kernel E: {e_ms:.4f} ms per launch, device (the key fill and "
          f"both passes) {ms_text(e_device_ms)}, the wrapper's PyTorch "
          f"kernels {ms_text(e_glue_ms)}, host hidden {ms_text(e_queued_ms)}")
    e_sweep = brute_sweep(kernel_e, e_args, pe, 20)
    print(f"kernel E by (rays per thread P, face chunk) (events, ms per "
          f"launch; each bit-equal to plain): {e_sweep}")
    def kernel_d():
        return clear._clear_cuda(n, CLEAR_VALUE, dev)

    def plain_d():
        return clear._clear_plain(n, CLEAR_VALUE, dev)

    d_ms = time_cuda(kernel_d, 100)
    d_device_ms = device_ms(kernel_d, 100)[0]
    d_queued_ms = time_queued(kernel_d, 100)
    d_plain_ms = time_cuda(plain_d, 100)
    d_plain_device_ms = device_ms(plain_d, 100)[0]
    d_plain_queued_ms = time_queued(plain_d, 100)
    print(f"config 2 frame ({size}x{size}, BRUTE): kernel path "
          f"{frame_ms:.4f} ms, plain path {plain_frame_ms:.4f} ms, "
          f"{n / frame_ms * 1e3:.6g} rays/s")
    print(f"kernel E: {e_ms:.4f} ms per launch (plain {e_plain_ms:.4f} ms); "
          f"kernel D: {d_ms:.4f} ms, device {ms_text(d_device_ms)}, host "
          f"hidden {ms_text(d_queued_ms)} (plain = torch.full "
          f"{d_plain_ms:.4f} ms, device {ms_text(d_plain_device_ms)}, host "
          f"hidden {ms_text(d_plain_queued_ms)})")
    clock.done("16 (config 2 checks, timing)")
    e_tests = e_args[1].shape[0] * e_args[2].shape[1]
    print(f"kernel E: {e_tests} ray-triangle tests")
    # D's plain version is one PyTorch call, `torch.full`: its library time.
    return {
        "clear": dict(launches=launches["clear"], err=0.0, ms=d_ms,
                      plain_ms=d_plain_ms, bound_ms_by=bound(0, 4 * n),
                      library_ms=d_plain_ms, device_ms=d_device_ms,
                      library_device_ms=d_plain_device_ms),
        "brute": dict(launches=launches["brute"], err=e_err, ms=e_ms,
                      plain_ms=e_plain_ms,
                      bound_ms_by=bound(e_tests * MT_OPS, nbytes(e_args, ke)),
                      device_ms=e_device_ms),
    }


def brute_err(k, p, name: str) -> tuple[int, int]:
    """Hold kernel E's (t, u, v, face) ``k`` against its plain version's
    ``p``: faces equal, t/u/v bit-equal, misses t = FLT_MAX, u = v = 0.
    Returns the hit rays and the hits at a negative t."""
    check(bool((k[3] == p[3]).all()), f"{name}: faces differ from plain: "
          f"{int((k[3] != p[3]).sum())} rays")
    for i, plane in enumerate("tuv"):
        check(bits_equal(k[i], p[i]), f"{name}: {plane} not bit-equal to "
              "plain")
    miss = k[3] < 0
    check(bool((k[0][miss] == float(3.4028234663852886e38)).all()
               and (k[1][miss] == 0).all() and (k[2][miss] == 0).all()),
          f"{name}: a miss without FLT_MAX, 0, 0")
    return int((~miss).sum()), int((~miss & (k[0] < 0)).sum())


def brute_calls_err(calls, name: str) -> None:
    """Hold each recorded call of kernel E (``calls``, its arguments) again
    against its plain version (`brute_err`)."""
    from raytracercuda_torch.trace import bruteforce

    hits = 0
    for args in calls:
        hits += brute_err(bruteforce._brute_cuda(*args),
                          bruteforce._brute_plain(*args),
                          f"kernel E ({name})")[0]
    check(len(calls) > 0, f"{name}: kernel E never launched")
    print(f"kernel E ({name}): {len(calls)} launches equal to plain, t/u/v "
          f"bit-equal, {hits} hits")


def brute_sweep(fn, e_args, want, iters: int) -> dict:
    """Kernel E's event time (ms per launch) at each rays per thread P and
    face chunk, each run held bit-equal to ``want`` (the plain version's
    output); the wrapper's constants are put back."""
    from raytracercuda_torch.trace import bruteforce

    keep = (bruteforce.BRUTE_RAYS_PER_THREAD, bruteforce.BRUTE_FACE_CHUNK)
    out = {}
    try:
        for p in (1, 2, 4, 8):
            for chunk in (512, 1024, 2048):
                bruteforce.BRUTE_RAYS_PER_THREAD = p
                bruteforce.BRUTE_FACE_CHUNK = chunk
                brute_err(fn(), want, f"kernel E (P = {p}, chunk {chunk})")
                out[(p, chunk)] = round(time_cuda(fn, iters), 4)
    finally:
        bruteforce.BRUTE_RAYS_PER_THREAD, bruteforce.BRUTE_FACE_CHUNK = keep
    return out


def brute_case_inputs(chunk: int, seed: int = 13) -> dict:
    """Kernel E's synthetic cases, ``{name: (positions [V, 3], faces
    [F, 3], origins [N, 3], directions [N, 3], clip_backward_hits)}`` in
    numpy float32 and int64, over a bumpy sphere of 3 face chunks of
    ``chunk`` faces and 357 more (neither ray nor face counts a multiple
    of the kernel's blocks): "duplicate_across_chunk", one face copied
    onto the next across the face-chunk boundary (chunk - 1 -> chunk) and
    across the first staged run's (127 -> 128), rays aimed at both (the
    earlier face must win); "inside_no_clip", origins inside the sphere
    with clipping off (negative t wins); "vertex_ties", origins on mesh
    vertices with clipping off (t = +-0.0 ties); "degenerate", faces (a,
    a, b), (a, b, a) and (a, a, a) ahead of the mesh for an edge a-b of 40
    faces (det = 0: a NaN or infinite u, a miss), rays aimed at those 40
    faces; "single_ray"."""
    import numpy as np

    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh

    rng = np.random.default_rng(seed)
    mesh = bumpy_sphere_mesh(3 * chunk + 357, center=(0.0, 0.0, 0.0),
                             seed=5)
    pos = np.asarray(mesh.positions, np.float32)
    tri = mesh.indices.reshape(-1, 3).astype(np.int64)

    def toward(faces, ids, n):
        """``n`` rays from outside toward points on the faces ``ids``."""
        pick = rng.choice(ids, n)
        w = rng.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
        on = (pos[faces[pick]] * w[:, :, None]).sum(axis=1)
        return on * np.float32(1.6), on - on * np.float32(1.6)

    def normal(n, scale=1.0):
        return (rng.normal(size=(n, 3)) * scale).astype(np.float32)

    cases = {}
    dup = tri.copy()
    for a in (chunk - 1, 127):
        dup[a + 1] = dup[a]
    cases["duplicate_across_chunk"] = (pos, dup,
                                       *toward(dup, [chunk - 1, 127], 999),
                                       True)
    cases["inside_no_clip"] = (pos, tri, normal(700, 0.2), normal(700), False)
    cases["vertex_ties"] = (pos, tri, pos[rng.choice(len(pos), 600)],
                            normal(600), False)
    picked = rng.choice(len(tri), 40)
    a, b = tri[picked, 0], tri[picked, 1]
    deg = np.concatenate([np.stack(v, 1) for v in ((a, a, b), (a, b, a),
                                                   (a, a, a))] + [tri])
    cases["degenerate"] = (pos, deg, *toward(deg, 120 + picked, 500), True)
    cases["single_ray"] = (pos, tri, *toward(tri, np.arange(len(tri)), 1),
                           True)
    return cases


def check_brute_case(name: str, chunk: int, face, t) -> str:
    """The property each of `brute_case_inputs`' cases exists for, on the
    winners ``face`` and their ``t`` (torch tensors); returns a note."""
    import torch

    if name == "duplicate_across_chunk":
        won = [int((face == a).sum()) for a in (chunk - 1, 127)]
        copies = [int((face == a).sum()) for a in (chunk, 128)]
        check(min(won) > 0 and max(copies) == 0, f"{name}: faces "
              f"{chunk - 1} and 127 won {won} rays, their copies {copies}")
        return f"; faces {chunk - 1} and 127 won {won} rays over their copies"
    if name == "inside_no_clip":
        check(int(((face >= 0) & (t < 0)).sum()) > 0,
              f"{name}: no hit at a negative t")
    if name == "vertex_ties":
        zero = (face >= 0) & (t == 0)
        check(int(zero.sum()) > 0, f"{name}: no hit at t = 0")
        return (f"; {int(zero.sum())} hits at t = 0 "
                f"({int((zero & torch.signbit(t)).sum())} at -0.0)")
    if name == "degenerate":
        check(not bool(((face >= 0) & (face < 120)).any()),
              f"{name}: a degenerate face won")
    if name == "single_ray":
        check(int((face >= 0).sum()) == 1, f"{name}: the ray missed")
    return ""


def brute_cases(dev) -> None:
    """Phase 16b: kernel E on `brute_case_inputs` at its face chunk, each
    held against its plain version (`brute_err`) and checked for the
    property it exists for (`check_brute_case`)."""
    import numpy as np
    import torch

    from raytracercuda_torch.trace import bruteforce

    chunk = bruteforce.BRUTE_FACE_CHUNK
    for name, (pos, faces, o, d, clip) in brute_case_inputs(chunk).items():
        args = (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                bruteforce.face_columns(torch.from_numpy(pos).to(dev),
                                        torch.from_numpy(faces).to(dev)),
                np.float32(1e-4) if clip else None)
        k = bruteforce._brute_cuda(*args)
        p = bruteforce._brute_plain(*args)
        hits, negative = brute_err(k, p, f"kernel E ({name})")
        note = check_brute_case(name, chunk, p[3], p[0])
        print(f"kernel E case {name}: {len(o)} rays, {len(faces)} faces, "
              f"{hits} hits, {negative} at t < 0{note}; equal to plain "
              f"(t/u/v bit-equal)")


def config5_scene(dev, meshes):
    """Config 5's scene (scripts/bench_configs.py:164-184): the three
    meshes of ``meshes``, reflectivity ``linspace(0.3, 0.6)`` over the
    materials (0.3 for the single default one), clusters built once, the
    eye from ``frame_eye(dist=1.2)``, orient the identity."""
    import torch

    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
    from raytracercuda_torch.models.scene import Scene

    config = RenderConfig(accel=AccelKind.CLUSTER)
    scene = Scene.create(config, device=dev)
    for faces, radius, center, seed in meshes:
        scene.add_mesh(bumpy_sphere_mesh(faces, radius=radius, center=center,
                                         seed=seed))
    data = scene.data()
    nm = data.reflectivity.shape[0]
    data = data._replace(reflectivity=torch.linspace(0.3, 0.6, nm,
                                                     device=dev))
    accel = scene.accel
    lo = data.positions.amin(dim=0)
    hi = data.positions.amax(dim=0)
    extent = float((hi - lo).amax())
    eye = ((lo + hi) / 2 - torch.tensor([0.0, 0.0, 1.2 * extent],
                                        device=dev)).to(torch.float32)
    return config, data, accel, eye


def bounce_path(dev, clock, card, width=C5_WIDTH, height=C5_HEIGHT,
                meshes=C5_MESHES, small=C5_SMALL, frames=3, c5=None):
    """Phases 17-21: config 5's multi-bounce frame, kernels A, B and F,
    and the brute-force route (kernel E) at a reduced size (``c5``: the
    scene of `config5_scene`, built here when None).  Returns F's JSON
    record and, for A and B, ``{name: (launches, max_abs_err)}`` of this
    path's run."""
    import torch

    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import bounce_sweep, bruteforce, sweep
    from raytracercuda_torch.trace.bounce import render_bounces
    from raytracercuda_torch.trace.pipeline import pad_frame, rotate_rays

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # 17. The scene and the frame, once, through A, B and F.
    config, data, accel, eye = c5 or config5_scene(dev, meshes)
    orient = torch.eye(3, device=dev)

    def rays(w, h):
        return rotate_rays(camera_ray_grid(w, h, device=dev), orient)

    dirs = rays(width, height)

    def frame(nb=2):
        return render_bounces(accel, data, eye, dirs, height, width, config,
                              num_bounces=nb)

    print(f"config 5: {data.num_faces} faces -> {accel.num_clusters} "
          f"clusters, {width}x{height}, eye {eye.tolist()}")
    frame()  # warm-up
    sync()
    rec_ab = Recorder(sweep, ["_primary_shade_cuda", "_occlusion_cuda"])
    rec_f = Recorder(bounce_sweep, ["_general_shade_cuda"])
    try:
        sweep.reset_launch_counts()
        img = frame()
        sync()
        launches = dict(sweep.launch_counts)
    finally:
        rec_ab.restore()
        rec_f.restore()
    print(f"config 5 launches: {launches}")
    check(launches["primary_shade"] > 0, "kernel A never launched")
    check(launches["occlusion"] > 0, "kernel B never launched")
    check(launches["general_shade"] == 2,
          f"kernel F launched {launches['general_shade']} times, not 2")
    check(launches["general_cull"] == 2,
          f"the general cull launched {launches['general_cull']} times, "
          f"not 2")
    staged_counts(launches, "config 5")
    check(tuple(img.shape) == (width * height, 3)
          and bool(torch.isfinite(img).all()), "config 5 image not finite")
    clock.done("17 (config 5 frame)")

    # 18. What each pass swept, and what the bounces changed.
    a_args = rec_ab.calls["_primary_shade_cuda"][-1]
    b_args = rec_ab.calls["_occlusion_cuda"][-1]
    a_lists = a_args[0]

    def list_stats(lists):
        counts = lists.counts
        listing = counts > 0
        mean = float(counts[listing].float().mean()) if listing.any() else 0
        return (f"{int(listing.sum())} of {counts.numel()} tiles list "
                f"clusters, mean {mean:.1f} over those, max "
                f"{int(counts.max())}")

    print(f"primary pass: {list_stats(a_lists)}")
    print(f"shadows: {int(b_args[3].sum())} active rays; "
          f"{list_stats(b_args[0])}")
    for b, args in enumerate(rec_f.calls["_general_shade_cuda"]):
        act = args[3]
        items, lanes = split_stats(args[0], sweep.GENERAL_CHUNK,
                                   act.shape[1], act)
        print(f"bounce {b + 1}: {int(act.sum())} active rays in "
              f"{int(act.any(dim=1).sum())} tiles; {list_stats(args[0])}; "
              f"kernel F: {items} work items at K = {sweep.GENERAL_CHUNK}, "
              f"{lanes:.2f} active lanes per warp")
    flat = frame(0)
    changed = float(((img - flat).abs() > 1e-6).any(dim=-1).float().mean())
    print(f"bounce_changed_px_frac {changed:.6f}")
    check(changed > 0.0, "the bounces change no pixel")
    clock.done("18 (config 5 lists)")

    # 19. A (with reflectivity) and B against their plain versions on this
    # frame's inputs, F on the first bounce's.
    check(a_args[5], "config 5: kernel A ran without reflectivity")
    ka = sweep._primary_shade_cuda(*a_args)
    pa, a_plain_ms = time_once(lambda: sweep._primary_shade_plain(*a_args))
    a_err, a_hits, _ = shade_err(ka, pa, "kernel A (config 5)")
    kb = sweep._occlusion_cuda(*b_args)
    pb, b_plain_ms = time_once(lambda: sweep._occlusion_plain(*b_args))
    b_err = occlusion_err(kb, pb, "kernel B (config 5)")
    print(f"kernel A (with reflectivity) matches plain on config 5: {a_hits} "
          f"hit rays, t/u/v bit-equal, attributes max abs err {a_err:.3g}; "
          f"kernel B matches plain: {int(pb.sum())} shadowed of "
          f"{int(b_args[3].sum())} active rays")
    f_err = 0.0
    for b, args in enumerate(rec_f.calls["_general_shade_cuda"]):
        kf = bounce_sweep._general_shade_cuda(*args)
        pf, plain_ms = time_once(
            lambda a=args: bounce_sweep._general_shade_plain(*a))
        err, f_hits, _ = shade_err(kf, pf, f"kernel F (bounce {b + 1})")
        f_err = max(f_err, err)
        if b == 0:
            f_plain_ms = plain_ms
        print(f"kernel F matches plain on bounce {b + 1}: {f_hits} hit "
              f"rays, t/u/v bit-equal, attributes max abs err {err:.3g}")
    f_args = rec_f.calls["_general_shade_cuda"][0]
    clock.done("19 (A, B, F vs plain)")
    case_a_err, case_f_err = split_sweep_cases(dev, accel, data, eye, config)
    a_err, f_err = max(a_err, case_a_err), max(f_err, case_f_err)
    clock.done("19b (C, A and F synthetic cases)")

    # 20. The cluster route against the brute-force route at a reduced
    # size (the JAX package's bar for its kernel route, test_bounce.py:192).
    sw, sh = small
    small_dirs = rays(sw, sh)

    def small_frame(use_brute):
        return render_bounces(accel, data, eye, small_dirs, sh, sw, config,
                              use_brute=use_brute)

    bruteforce.reset_launch_counts()
    rgb_c = small_frame(False)
    rec_e = Recorder(bruteforce, ["_brute_cuda"])
    try:
        rgb_b = small_frame(True)
        sync()
    finally:
        rec_e.restore()
    brute_launches = bruteforce.launch_counts["brute"]
    share = float(torch.isclose(rgb_c, rgb_b, rtol=1e-4, atol=1e-4)
                  .all(dim=-1).float().mean())
    print(f"config 5 at {sw}x{sh}: cluster route vs brute route (kernel E, "
          f"{brute_launches} launches): {share:.6f} of pixels within 1e-4")
    check(brute_launches > 0, "kernel E never launched")
    check(share >= 0.99, f"cluster vs brute route: share {share} < 0.99")
    # E against its plain version on the primary rays' launch.
    e_args = rec_e.calls["_brute_cuda"][0]
    pe, e_plain_ms = time_once(lambda: bruteforce._brute_plain(*e_args))
    hits, _ = brute_err(bruteforce._brute_cuda(*e_args), pe,
                        "kernel E (config 5 brute route)")
    e_ms = time_cuda(lambda: bruteforce._brute_cuda(*e_args), 3)
    brute_frame_ms = time_cuda(lambda: small_frame(True), 2)
    cluster_frame_ms = time_cuda(lambda: small_frame(False), 5)
    print(f"kernel E on the brute route's primary rays ({e_args[1].shape[0]} "
          f"rays, {e_args[2].shape[1]} faces): equal to plain, t/u/v "
          f"bit-equal, {hits} hits; {e_ms:.4f} ms per launch (plain "
          f"{e_plain_ms:.4f} ms, one run); the {sw}x{sh} frame: brute route "
          f"{brute_frame_ms:.4f} ms, cluster route {cluster_frame_ms:.4f} ms")
    clock.done("20 (cluster vs brute route)")

    # 21. Timing: the frame, F, one frame with the bounces re-binned.
    print(f"timing on {card}")
    frame_ms = time_cuda(frame, frames)

    def kernel_f():
        return bounce_sweep._general_shade_cuda(*f_args)

    f_ms = time_cuda(kernel_f, 5)
    f_device_ms, f_glue_ms = device_ms(kernel_f, 5, SPLIT_KERNELS)[:2]
    f_queued_ms = time_queued(kernel_f, 5)
    print(f"kernel F (bounce 1): {f_ms:.4f} ms per launch, device (both "
          f"passes and the key fill) {ms_text(f_device_ms)}, the split's "
          f"PyTorch kernels {ms_text(f_glue_ms)}, host hidden "
          f"{ms_text(f_queued_ms)}")
    for b, args in enumerate(rec_f.calls["_general_shade_cuda"]):
        f_k = k_sweep(sweep, "GENERAL_CHUNK", (4, 8, 16, 32, 64),
                      lambda a=args: bounce_sweep._general_shade_cuda(*a), 5,
                      args[0], args[3].shape[1], args[3])
        print(f"kernel F (bounce {b + 1}) by K ({K_SWEEP_FIELDS}): {f_k}")

    def kernel_a():
        return sweep._primary_shade_cuda(*a_args)

    def kernel_b():
        return sweep._occlusion_cuda(*b_args)

    a_ms = time_cuda(kernel_a, 20)
    b_ms = time_cuda(kernel_b, 20)
    split_chunk_report(sweep, "config 5", kernel_a, kernel_b, a_args, b_args,
                       20)
    tp = config.trace.dense_tile_px
    pdirs, hp, wp = pad_frame(dirs, height, width, tp)
    blocks, has_uv = sweep.shade_segment_blocks(accel, data)

    def tiled(sort):
        return bounce_sweep.render_bounces_tiled(
            accel, blocks, has_uv, data.textures, eye, pdirs, hp, wp,
            tile_px=tp, trace_cfg=config.trace, sort_bounces=sort)

    unsorted = tiled(False)
    sorted_img, sorted_ms = time_once(lambda: tiled(True))
    sort_diff = float((sorted_img - unsorted).abs().max())
    print(f"config 5 frame ({width}x{height}, 2 bounces, shadows): "
          f"{frame_ms:.4f} ms, {width * height / frame_ms * 1e3:.6g} rays/s "
          f"(W*H per frame); sort_bounces=True frame {sorted_ms:.4f} ms "
          f"(one frame, no warm-up), max abs diff to unsorted {sort_diff:.3g}")
    check(sort_diff <= 1e-6, f"sorted bounces differ by {sort_diff}")
    print(f"kernel F (bounce 1): {f_ms:.4f} ms per launch (plain "
          f"{f_plain_ms:.4f} ms, one run); on config 5, kernel A "
          f"{a_ms:.4f} ms (plain {a_plain_ms:.4f} ms, one run), kernel B "
          f"{b_ms:.4f} ms (plain {b_plain_ms:.4f} ms, one run)")
    clock.done("21 (config 5 timing)")
    f_tests = sweep_tests(f_args[0], f_args[2].shape[2], f_args[4].shape[1],
                          active=f_args[3])
    print(f"kernel F (bounce 1): {f_tests} ray-triangle tests")
    f_record = kernel_record(
        "general_shade", "raytracercuda_torch/csrc/sweep.cu",
        "raytracercuda_tpu/trace/pallas_bounce.py:108",
        launches["general_shade"], f_err, f_ms, f_plain_ms,
        bound(f_tests * MT_OPS, nbytes(f_args, kernel_f())),
        device_ms=f_device_ms)
    return [f_record], {"primary_shade": (launches["primary_shade"], a_err),
                        "occlusion": (launches["occlusion"], b_err)}


def split_sweep_cases(dev, accel, data, eye, config) -> tuple:
    """Phase 19b: kernels C, A and F on synthetic inputs over config 5's
    clusters, each held against its plain version (slots equal, t/u/v
    bit-equal, A's and F's attributes within 1e-5; A with and without
    reflectivity on every case with a common origin): one tile that lists
    every cluster (and one that lists none); an exact tie, one triangle
    copied into the last cluster, a work item away, where the earlier
    slot must win; ``clip_backward_hits=False`` with the origin inside a
    mesh, where hits at a negative t win; for F, a bounce with one active
    ray.  Returns A's and F's largest attribute errors."""
    import numpy as np
    import torch

    from raytracercuda_torch.trace import sweep

    rng = np.random.default_rng(11)
    geom = sweep.segment_blocks(accel)
    shade, has_uv = sweep.shade_segment_blocks(accel, data)
    c, g = geom.shape[0], geom.shape[1]
    r = 256
    t_eps = sweep.t_eps_of(config.trace)
    every = torch.ones((1, c), dtype=torch.bool, device=dev)
    lists = sweep._tile_lists(torch.cat([every, ~every]))  # all, none
    one = sweep._tile_lists(every)
    slots = (accel.face_order >= 0).nonzero()[:, 0]
    tris = accel.tris.reshape(-1, 9)

    def on_triangles(n, slot=None):
        """Points on ``n`` random real triangles (or all on ``slot``)."""
        pick = (slots[torch.from_numpy(rng.integers(0, slots.numel(), n))
                      .to(dev)] if slot is None
                else torch.full((n,), slot, device=dev))
        tri = tris[pick]
        w = torch.from_numpy(rng.dirichlet((1.0, 1.0, 1.0), n)
                             .astype(np.float32)).to(dev)
        return (tri[:, 0:3] * w[:, 0:1] + tri[:, 3:6] * w[:, 1:2]
                + tri[:, 6:9] * w[:, 2:3])

    def jitter(p, n, scale):
        return p + torch.from_numpy(rng.normal(0.0, scale, (n, 3))
                                    .astype(np.float32)).to(dev)

    # The tie: slot `a` copied over slot `b` in the last cluster, the eye
    # just above the triangle's centre, the rays through points on it.
    a = int(slots[slots.numel() // 3])
    b = (c - 1) * g + 5
    geom_tie, shade_tie = geom.clone(), shade.clone()
    geom_tie.view(-1, 9)[b] = geom.view(-1, 9)[a]
    shade_tie.view(-1, shade.shape[2])[b] = shade.view(-1, shade.shape[2])[a]
    v0, e1, e2 = geom.view(-1, 9)[a].view(3, 3)
    normal = torch.linalg.cross(e1, e2)
    tie_eye = (v0 + (e1 + e2) / 3 + normal / normal.norm()
               * 0.25 * float(e1.norm())).contiguous()
    centre = torch.tensor(C5_MESHES[1][2], dtype=torch.float32, device=dev)

    # name: (lists, origins [T*R, 3], directions [T*R, 3], geometry, shade
    # rows, t_eps, active [T, R] for F or None)
    cases = {}
    d2 = on_triangles(2 * r) - eye
    cases["every_cluster"] = (lists, eye.expand(2 * r, 3), d2, geom, shade,
                              t_eps, None)
    cases["tie_across_items"] = (one, tie_eye.expand(r, 3),
                                 on_triangles(r, a) - tie_eye, geom_tie,
                                 shade_tie, t_eps, None)
    units = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(r, 3)).astype(np.float32)).to(dev), dim=1)
    cases["inside_no_clip"] = (one, centre.expand(r, 3), units, geom, shade,
                               None, None)
    single = torch.zeros((1, r), dtype=torch.bool, device=dev)
    single[0, 77] = True
    cases["one_active_ray"] = (one, jitter(eye.expand(r, 3), r, 0.01),
                               on_triangles(r) - eye, geom, shade, t_eps,
                               single)
    worst_a = worst_f = 0.0
    for name, (lst, o, d, gm, sh, te, act) in cases.items():
        num_tiles = lst.counts.numel()
        d_tiles = d.reshape(num_tiles, r, 3).contiguous()
        checked = []
        if act is None:  # C: the common origin
            args = (lst, o[0].contiguous(), d_tiles, gm, te)
            kc = sweep._primary_cuda(*args)
            pc = sweep._primary_plain(*args)
            hits, negative = closest_err(kc, pc, f"kernel C ({name})")
            checked.append(f"C {hits} hits, {negative} at t < 0")
            # A with reflectivity against plain, and without it against
            # the same planes but the last.
            d3 = d_tiles.transpose(1, 2).contiguous()
            aargs = (lst, o[0].contiguous(), d3, sh, has_uv)
            pa = sweep._primary_shade_plain(*aargs, True, te)
            for refl in (True, False):
                ka = sweep._primary_shade_cuda(*aargs, refl, te, gm)
                err, hits, negative = shade_err(
                    ka, pa if refl else pa[:-1],
                    f"kernel A ({name}, with_refl={refl})")
                worst_a = max(worst_a, err)
            checked.append(f"A {hits} hits, {negative} at t < 0, with and "
                           "without reflectivity")
            won = torch.cat([pc[3].reshape(-1), pa[1].reshape(-1)])
        active = act if act is not None else torch.rand(
            (num_tiles, r), generator=torch.Generator(dev).manual_seed(3),
            device=dev) < 0.9
        fargs = (lst, o.reshape(num_tiles, r, 3).transpose(1, 2).contiguous(),
                 d_tiles.transpose(1, 2).contiguous(), active, sh, has_uv,
                 te, gm)
        kf = sweep._general_shade_cuda(*fargs)
        pf = sweep._general_shade_plain(*fargs)
        err, hits, negative = shade_err(kf, pf, f"kernel F ({name})")
        worst_f = max(worst_f, err)
        checked.append(f"F {hits} hits of {int(active.sum())} active rays, "
                       f"{negative} at t < 0")
        if act is None:
            won = torch.cat([won.reshape(-1), pf[1].reshape(-1)])
        if name == "tie_across_items":
            check(int((won == a).sum()) > 0 and not bool((won == b).any()),
                  f"tie: slot {a} won {int((won == a).sum())} times, its "
                  f"copy {b} {int((won == b).sum())} times")
            checked.append(f"slot {a} won {int((won == a).sum())} rays over "
                           f"its copy {b}")
        if name == "inside_no_clip":
            check(negative > 0, "inside_no_clip: no hit at a negative t")
        if name == "one_active_ray":
            check(hits <= 1 and int(kf[1][~active].abs().sum()) == 0,
                  "one_active_ray: inactive rays hit")
        print(f"split sweep case {name}: {'; '.join(checked)}; equal to "
              f"plain (t/u/v bit-equal)")
    return worst_a, worst_f


def gradient_reference(size: int):
    """numpy transcription of `Gradient.cu:5-41`: float32 arithmetic as the
    CUDA kernel computes it, packed pixels as uint32."""
    import numpy as np

    i = np.arange(size)
    block = size // 6
    c = (np.float32(255) * ((i % block).astype(np.float32)
                            / np.float32(block))).astype(np.uint32)
    bands = [c << 16, c << 8, c, (c << 16) | (c << 8), (c << 8) | c,
             (c << 16) | c]
    return np.select([i // block == k for k in range(6)], bands,
                     np.uint32(0))


def frame_bits(frame, name: str):
    """Hold ``frame`` to the port's framebuffer type, ``torch.uint32`` at 4
    bytes a pixel, and return its int32 bits (a view): the card has no
    shifts, masks or reductions on uint32."""
    import torch

    check(frame.dtype == torch.uint32 and frame.element_size() == 4,
          f"{name}: the frame is {frame.dtype}, not torch.uint32")
    return frame.view(torch.int32)


def u8_diff(a, b) -> int:
    """The largest difference of one u8 channel between packed frames
    (each held to `frame_bits`)."""
    a, b = frame_bits(a, "u8_diff"), frame_bits(b, "u8_diff")
    return max(int((((a >> s) & 0xFF) - ((b >> s) & 0xFF)).abs().max())
               for s in (16, 8, 0))


def host_copies(fn) -> dict:
    """``{name: count}`` of the copies `torch.profiler` records over one
    call of ``fn`` (after a warm-up): the card's copies from the host
    ("Memcpy HtoD ..."), the runtime's ``cudaMemcpy*`` calls and
    ``aten::copy_``.  The last is a CPU operator, which the profiler
    records even where it drops the card's copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if "HtoD" in e.key or e.key.startswith("cudaMemcpy")
            or e.key == "aten::copy_"}


def rotating(fn, keep: int = FILL_KEEP):
    """``fn`` with its last ``keep`` outputs held, so that repeated calls
    write fresh memory: a 1920x1080 frame's 8.3 MB, 16 deep, is more than
    twice what the 50 MB L2 holds."""
    import collections

    held = collections.deque(maxlen=keep)
    return lambda: held.append(fn())


def fill_times(fn, iters: int, kernel: str) -> tuple:
    """``(events, device, host hidden)`` ms a call of a fill, its outputs
    rotated (`rotating`): CUDA events, the profiler's time of ``kernel``,
    and `time_queued`."""
    run = rotating(fn)
    return (time_cuda(run, iters), device_ms(run, iters, (kernel,))[0],
            time_queued(run, iters))


def times_text(t) -> str:
    return (f"{t[0]:.4f} ms by events, device {ms_text(t[1])}, host hidden "
            f"{ms_text(t[2])}")


def same_values(new, old) -> bool:
    """This tree's uint32 frame and a parent's (int64 or uint32) hold the
    same pixel values."""
    import torch

    return torch.equal(new.to(torch.int64), old.to(torch.int64))


def parent_fill_fns(parent_build):
    """The parent's kernels D, I and J, called as this tree's `_clear_cuda`,
    `_gradient_cuda` and `_blob_cuda` (the time a float32 tensor on the
    card), through the entries `rt_clear(out, n, value, stream)`,
    `rt_gradient(out, size, stream)` and `rt_blob(out, w, h, time,
    time_value, stream)` of the parent's library.  ``parent_build`` is the
    parent's `ops/cuda_build` module: its frames are uint32 where it states
    `PIXEL_BYTES = 4`, else int64 (the 8-byte pixels before it); compare
    them with this tree's by value (`same_values`)."""
    import torch

    from raytracercuda_torch.ops.cuda_build import raw_stream

    lib = parent_build.load_library()
    wide = getattr(parent_build, "PIXEL_BYTES", 8) == 8
    dtype = torch.int64 if wide else torch.uint32

    def clear(n, dev):
        out = torch.empty(n, dtype=dtype, device=dev)
        err = lib.rt_clear(out.data_ptr(), n, CLEAR_VALUE, raw_stream(dev))
        check(err == 0, f"parent's D failed: CUDA error {err}")
        return out

    def gradient(n, dev):
        out = torch.empty(n, dtype=dtype, device=dev)
        err = lib.rt_gradient(out.data_ptr(), n, raw_stream(dev))
        check(err == 0, f"parent's I failed: CUDA error {err}")
        return out

    def blob(w, h, time, dev):
        out = torch.empty(w * h, dtype=dtype, device=dev)
        err = lib.rt_blob(out.data_ptr(), w, h, time.data_ptr(), 0.0,
                          raw_stream(dev))
        check(err == 0, f"parent's J failed: CUDA error {err}")
        return out

    return clear, gradient, blob


def fill_path(dev, clock, card, size=C1_SIZE, sizes=FILL_SIZES,
              parent=None):
    """Phases 22-24: config 1's full-frame fills, kernels D, I and J, and
    D, I and J at ``sizes`` (width, height).  ``parent``: the directory of
    an unpacked parent commit, whose D, I and J phase 24 times in turns
    with this tree's.  Returns I's and J's records and D's launches on
    this path."""
    import numpy as np
    import torch

    from raytracercuda_torch.ops import blob, clear, gradient

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    n = size * size
    times = [torch.tensor([t], dtype=torch.float32, device=dev)
             for t in BLOB_TIMES]

    # 22. The main path: clear (D), the gradient (I), then the blob (J) at
    # three times, the first given as a float.
    for m in (clear, gradient, blob):
        m.reset_launch_counts()
    cleared = clear.clear_buffer(n, CLEAR_VALUE, dev)
    frame = gradient.color_gradient(size, size, dev)
    blobs = [blob.blob(size, size, BLOB_TIMES[0], dev)]
    blobs += [blob.blob(size, size, t, dev) for t in times[1:]]
    sync()
    launches = {**clear.launch_counts, **gradient.launch_counts,
                **blob.launch_counts}
    print(f"config 1 launches: {launches}")
    check(launches["clear"] > 0, "kernel D never launched")
    check(launches["gradient"] > 0, "kernel I never launched")
    check(launches["blob"] == len(BLOB_TIMES), "kernel J launched "
          f"{launches['blob']} times, not {len(BLOB_TIMES)}")
    for name, f in [("clear_buffer", cleared), ("color_gradient", frame),
                    *(("blob", b) for b in blobs)]:
        frame_bits(f, f"config 1 {name}")
        check(f.shape == (n,), f"config 1 {name}: shape {tuple(f.shape)}")
    check(torch.equal(cleared, torch.full((n,), CLEAR_VALUE,
                                          dtype=torch.uint32, device=dev)),
          "kernel D: buffer differs from torch.full")
    check(int(cleared[:1].to(torch.int64)) == CLEAR_VALUE,
          "kernel D: 0xFF00FF00 does not read back")
    clock.done("22 (config 1 frame)")

    # 23. D and I bit-equal to their plain versions (I also to
    # `Gradient.cu`), J bit-equal to its plain version at
    # each time, a float time against a device tensor's, at config 1's
    # size (phase 22's frames), 1920x1080 and an odd size.
    for w, h in sizes:
        m = w * h
        main = (w, h) == (size, size)
        check(torch.equal(cleared if main else clear._clear_cuda(
            m, CLEAR_VALUE, dev), clear._clear_plain(m, CLEAR_VALUE, dev)),
            f"kernel D differs from its plain version at {w}x{h}")
        plain = gradient._gradient_plain(m, dev)
        k = frame if main else gradient._gradient_cuda(m, dev)
        check(torch.equal(k, plain),
              f"kernel I differs from its plain version at {w}x{h}")
        check(np.array_equal(k.cpu().numpy(), gradient_reference(m)),
              f"kernel I differs from the transcription of Gradient.cu at "
              f"{w}x{h}")
        for i, (t, tt) in enumerate(zip(BLOB_TIMES, times)):
            kf = blob._blob_cuda(w, h, t, dev)
            kt = blobs[i] if main else blob._blob_cuda(w, h, tt, dev)
            check(torch.equal(kf, kt), f"kernel J at {w}x{h}, time {t}: a "
                  "float time and a device tensor's give other frames")
            p = blob._blob_plain(w, h, tt, dev)
            check(torch.equal(kf, p), f"kernel J at {w}x{h}, time {t}: "
                  f"{int((kf != p).sum())} pixels differ from plain, u8 "
                  f"diff {u8_diff(kf, p)}")
        print(f"at {w}x{h}: kernel D equals its plain version; kernel I "
              f"equals its plain version and Gradient.cu; kernel J at times {BLOB_TIMES} (a float "
              f"and a device tensor, equal frames) equals its plain version")
    check(not torch.equal(blobs[0], blobs[1]),
          "kernel J: two times give the same frame")
    if dev.type == "cuda":  # the entry points' default device, the card
        check(torch.equal(blob.blob(size, size, times[1]), blobs[1])
              and torch.equal(gradient.color_gradient(size, size), frame),
              "blob or color_gradient on the default device differs")
    copies = host_copies(lambda: blob.blob(size, size, 1.25, dev))
    seen = host_copies(lambda: torch.tensor([1.25], device=dev))
    print(f"copies a call: blob(..., 1.25) {copies}; "
          f"torch.tensor([1.25], device=cuda) {seen}")
    check(bool(seen), "the profiler records no copy of torch.tensor(..., "
          "device=cuda): the check below sees nothing")
    check(not copies, f"blob with a float time copies: {copies}")
    clock.done("23 (D, I, J vs plain)")

    # 24. Timing: D, I and J by events, on the card and with the host
    # hidden (J with a float time and with a device tensor), each beside its plain version and
    # bound at 4 bytes a pixel and, with ``parent``, the parent's in turns
    # (outputs compared by value), at config 1's size and 1920x1080 (D
    # also at config 5's edge-padded 1920x1088).
    print(f"timing on {card}")

    def config1_frame():
        clear.clear_buffer(n, CLEAR_VALUE, dev)
        return gradient.color_gradient(size, size, dev)

    frame_ms = time_cuda(config1_frame, 200)
    with PlainOnCard({clear: {"_clear_cuda": clear._clear_plain},
                      gradient: {"_gradient_cuda": gradient._gradient_plain}}):
        frame_plain_ms = time_cuda(config1_frame, 100)
    print(f"config 1 frame ({size}x{size}, clear then gradient): kernel "
          f"path {frame_ms:.4f} ms, plain path {frame_plain_ms:.4f} ms")
    entry = time_cuda(lambda: blob.blob(size, size, 1.25, dev), 200)
    print(f"blob({size}, {size}, 1.25) through the entry point: "
          f"{entry:.4f} ms by events")
    old = parent_fill_fns(parent_build(parent)) if parent else None

    def in_turns(name, w, h, new, old_fn, kernel, iters):
        """The parent's ``old_fn`` and this tree's ``new`` in turns, their
        outputs equal by value."""
        check(same_values(new(), old_fn()), f"kernel {name} differs from "
              f"the parent's at {w}x{h}")
        turns = [time_cuda(rotating(f), iters)
                 for f in (old_fn, new, new, old_fn)]
        dev_new = device_ms(rotating(new), iters, (kernel,))[0]
        dev_old = device_ms(rotating(old_fn), iters, (kernel,))[0]
        q_new = time_queued(rotating(new), iters)
        q_old = time_queued(rotating(old_fn), iters)
        print(f"{w}x{h}: kernel {name} against the parent ({parent}), equal "
              f"values; by events parent, this, this, parent: "
              + ", ".join(f"{t:.4f}" for t in turns)
              + f" ms; on the card this {ms_text(dev_new)}, parent "
              f"{ms_text(dev_old)}; host hidden this {ms_text(q_new)}, "
              f"parent {ms_text(q_old)}")

    def report(name, w, h, t, plain_ms, bnd):
        print(f"{w}x{h} on {card}: kernel {name} {times_text(t)} (plain "
              f"{plain_ms:.4f} ms); bound {bnd[0]:.6f} ms by {bnd[1]}, "
              f"{bnd[0] / t[0]:.2%} of it reached by events, "
              f"{share_text(bnd[0], t[1])} on the card, "
              f"{share_text(bnd[0], t[2])} with the host hidden")

    for w, h in CLEAR_TIMED:
        m = w * h
        iters = 200 if m <= n else 100
        fd = lambda m=m: clear._clear_cuda(m, CLEAR_VALUE, dev)  # noqa: E731
        d_t = fill_times(fd, iters, "clear_kernel")
        d_plain = time_cuda(rotating(lambda m=m: clear._clear_plain(
            m, CLEAR_VALUE, dev)), iters)
        report("D", w, h, d_t, d_plain, bound(0, 4 * m))
        if old:
            in_turns("D", w, h, fd, lambda m=m: old[0](m, dev),
                     "clear_kernel", iters)
    timed = {}
    for w, h in sizes[:2]:
        m = w * h
        iters, plain_iters = (200, 100) if m <= n else (200, 10)
        fi = lambda m=m: gradient._gradient_cuda(m, dev)  # noqa: E731
        fjf = lambda w=w, h=h: blob._blob_cuda(w, h, 1.25, dev)  # noqa: E731
        fjt = lambda w=w, h=h: blob._blob_cuda(  # noqa: E731
            w, h, times[1], dev)
        i_t = fill_times(fi, iters, "gradient_kernel")
        jf_t = fill_times(fjf, iters, "blob_kernel")
        jt_t = fill_times(fjt, iters, "blob_kernel")
        i_plain = time_cuda(rotating(lambda m=m: gradient._gradient_plain(
            m, dev)), plain_iters)
        j_plain = time_cuda(rotating(lambda w=w, h=h: blob._blob_plain(
            w, h, times[1], dev)), plain_iters)
        i_bound = bound(GRADIENT_OPS * (m // 6), 4 * m)
        j_bound = bound(BLOB_OPS * m + BLOB_ROW_OPS * h, 4 * m + 4)
        timed[(w, h)] = (i_t, jt_t, i_plain, j_plain, i_bound, j_bound)
        report("I", w, h, i_t, i_plain, i_bound)
        print(f"{w}x{h} on {card}: kernel J, float time, {times_text(jf_t)}"
              f"; device tensor time, {times_text(jt_t)} (plain "
              f"{j_plain:.4f} ms); bound {j_bound[0]:.6f} ms by {j_bound[1]}"
              f", {j_bound[0] / jt_t[0]:.2%} of it reached by events, "
              f"{share_text(j_bound[0], jt_t[1])} on the card, "
              f"{share_text(j_bound[0], jt_t[2])} with the host hidden "
              f"(float time {share_text(j_bound[0], jf_t[2])})")
        if old:
            in_turns("I", w, h, fi, lambda m=m: old[1](m, dev),
                     "gradient_kernel", iters)
            in_turns("J", w, h, fjt,
                     lambda w=w, h=h: old[2](w, h, times[1], dev),
                     "blob_kernel", iters)
    if parent is None:
        print("parent's kernels D, I and J: not timed (no --parent)")
    clock.done("24 (config 1 timing)")
    src = "raytracercuda_torch/csrc/frame.cu"
    i_t, j_t, i_plain, j_plain, i_bound, j_bound = timed[(size, size)]
    return [
        kernel_record("gradient", src, "raytracercuda_tpu/ops/gradient.py:60",
                      launches["gradient"], 0.0, i_t[0], i_plain, i_bound,
                      device_ms=i_t[1]),
        kernel_record("blob", src, "raytracercuda_tpu/ops/blob.py:66",
                      launches["blob"], 0.0, j_t[0], j_plain, j_bound,
                      device_ms=j_t[1]),
    ], launches["clear"]


def read_png(path: str):
    """``[H, W, 3]`` uint8 pixels of an RGB PNG with unfiltered rows (what
    `utils/png.write_png` writes)."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(bool((raw[:, 0] == 0).all()), f"{path}: filtered rows")
    return raw[:, 1:].reshape(h, w, 3)


def app_path(dev, clock, card, size=APP_SIZE, faces=C2_SUZANNE, frames=3,
             fly_size=FLY_SIZE):
    """Phases 25-28: the TestProgram path.  A textured stand-in for
    suzanne.obj through `load_model` (the native tokenizer), the render
    CLI's five routes (A and B, C, E; on BVH, L for parity and L and K's
    any hit for lambert-shadow) held against the same runs on the plain
    versions, the fly loop on BRUTE (E), and `fly.main` with its default
    structure (BVH, kernel L) held against its run on the plain versions.
    Returns the launches of A, B, C, E, K and L on this path."""
    import tempfile

    import numpy as np
    import torch

    import raytracercuda_torch as rt
    from raytracercuda_torch.apps import fly, render_cli
    from raytracercuda_torch.models import loader
    from raytracercuda_torch.trace import beam, bruteforce, sweep, traverse

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        # 25. The model, through load_model on the native tokenizer.
        path = write_textured_obj(tmp, faces, 64)
        scene = rt.Scene.create(rt.RenderConfig(accel=rt.AccelKind.BRUTE),
                                device=dev)
        native = loader.parse_routes["native"]
        t0 = time.perf_counter()
        check(loader.load_model(path, scene), "load_model failed")
        data = scene.data()
        sync()
        load_s = time.perf_counter() - t0
        check(loader.parse_routes["native"] == native + 1,
              "load_model did not run the native OBJ tokenizer")
        check(data.num_faces == faces, f"{data.num_faces} faces loaded")
        print(f"load_model: {data.num_faces} faces, {len(scene.materials)} "
              f"materials, {len(scene.textures)} texture(s), {load_s:.3f} s "
              f"(native tokenizer)")
        clock.done("25 (load_model)")

        # 26. The CLI's routes through the kernels.
        routes = {  # name: (flags, the kernels the route must launch)
            "lambert-shadow": (["--accel", "cluster", "--shading",
                                "lambert-shadow", "--size", str(size)],
                               ("primary_shade", "occlusion")),
            "parity": (["--accel", "cluster", "--shading", "parity",
                        "--size", str(size)], ("primary",)),
            "brute": (["--accel", "brute", "--shading", "parity", "--size",
                       str(fly_size)], ("brute",)),
            "bvh-parity": (["--accel", "bvh", "--shading", "parity",
                            "--size", str(size)], ("beam",)),
            "bvh-lambert-shadow": (["--accel", "bvh", "--shading",
                                    "lambert-shadow", "--size", str(size)],
                                   ("beam", "walk_any")),
        }
        common = ["--frames", str(frames), "--orbit", "15"]
        launches = {"primary_shade": 0, "occlusion": 0, "primary": 0,
                    "brute": 0, "beam": 0, "walk_any": 0, "walk_closest": 0}

        def reset():
            for m in (sweep, bruteforce, beam, traverse):
                m.reset_launch_counts()

        def counts():
            return {**sweep.launch_counts, **bruteforce.launch_counts,
                    **beam.launch_counts, **traverse.launch_counts}

        rec_e = Recorder(bruteforce, ["_brute_cuda"])
        try:
            for name, (flags, kernels) in routes.items():
                argv = [path, *flags, *common, "-o", os.path.join(tmp, name)]
                if name == "lambert-shadow":
                    argv.append("--profile")
                reset()
                check(render_cli.main(argv) == 0,
                      f"render CLI ({name}) failed")
                sync()
                got = counts()
                print(f"render CLI {name}: launches {got}")
                for k in kernels:
                    check(got[k] > 0, f"render CLI {name}: kernel {k} "
                          "never launched")
                    launches[k] += got[k]
        finally:
            rec_e.restore()
        brute_calls_err(rec_e.calls["_brute_cuda"], "render CLI brute")
        clock.done("26 (render CLI)")

        # 27. The same runs on the plain versions: parity routes equal,
        # lambert within 1 per u8 channel.
        plain = {
            sweep: {"_primary_shade_cuda": sweep._primary_shade_plain,
                    "_occlusion_cuda": sweep._occlusion_plain,
                    "_primary_cuda": sweep._primary_plain},
            bruteforce: {"_brute_cuda": bruteforce._brute_plain},
            beam: {"_beam_cuda": beam._beam_plain},
            traverse: {"_walk_closest_cuda": traverse._walk_closest_plain,
                       "_walk_any_cuda": traverse._walk_any_plain}}
        with PlainOnCard(plain):
            for name, (flags, _) in routes.items():
                check(render_cli.main([path, *flags, *common, "-o",
                                       os.path.join(tmp, name + "_plain")])
                      == 0, f"render CLI ({name}, plain) failed")
        for name in routes:
            bar = 1 if name == "lambert-shadow" else 0  # FrameRenderer
            worst, hit = 0, 0.0
            for f in range(frames):
                png = f"frame_{f:04d}.png"
                k = read_png(os.path.join(tmp, name, png)).astype(np.int64)
                p = read_png(os.path.join(tmp, name + "_plain", png))
                worst = max(worst, int(np.abs(k - p).max()))
                hit = max(hit, float((k != k[0, 0]).any(axis=-1).mean()))
            print(f"render CLI {name}: {frames} frames, max u8 diff to the "
                  f"plain path {worst} (bar {bar}), up to {hit:.4f} of "
                  f"pixels off the background")
            check(worst <= bar, f"render CLI {name}: u8 diff {worst}")
            check(hit > 0.0, f"render CLI {name}: the model is not in view")
        clock.done("27 (CLI plain path)")

        # 28. The fly loop on BRUTE with a scripted event list.
        cam = rt.Camera.create(dev)
        check(cam.set_initial_rays(fly_size, fly_size) == 0, "fly camera")
        rts = [rt.RenderTarget.create(fly_size, fly_size, dev)
               for _ in range(fly.NUM_RT)]
        check(rts[0].lock() == 0, "fly: lock")
        lo = data.positions.amin(dim=0).cpu().numpy()
        hi = data.positions.amax(dim=0).cpu().numpy()
        state = fly.FlyState((lo + hi) / 2 - np.array(
            [0.0, 0.0, 2.0 * float(np.max(hi - lo))]))
        events = {0: [{"event": "keydown", "key": "w"}],
                  1: [{"event": "mouse", "xrel": 40, "yrel": -12}],
                  2: [{"event": "keyup", "key": "w"},
                      {"event": "keydown", "key": "q"}]}
        seen = []
        bruteforce.reset_launch_counts()
        rec_e = Recorder(bruteforce, ["_brute_cuda"])
        try:
            done = fly.run_loop(
                scene, cam, rts, state, events, FLY_FRAMES, None,
                on_frame=lambda f, s, i, buf: seen.append(
                    (i, float((buf != 255 << 8).mean()), buf.dtype)))
            sync()
        finally:
            rec_e.restore()
        fly_launches = bruteforce.launch_counts["brute"]
        brute_calls_err(rec_e.calls["_brute_cuda"], "fly loop")
        print(f"fly loop: {done} frames, render targets "
              f"{[i for i, _, _ in seen]}, hit shares "
              f"{[round(s, 4) for _, s, _ in seen]}, {fly_launches} launches "
              f"of E, eye {state.pos.tolist()}")
        check(done == FLY_FRAMES, f"fly loop rendered {done} frames")
        check(all(d == np.uint32 for _, _, d in seen),
              f"fly loop: frames of {[d for _, _, d in seen]}, not uint32")
        check([i for i, _, _ in seen] == [1, 2, 0, 1][:FLY_FRAMES],
              "fly loop: render-target rotation")
        check(fly_launches >= FLY_FRAMES, "fly loop: kernel E not launched")
        check(not any(r.locked for r in rts), "fly loop left a target locked")
        launches["brute"] += fly_launches

        # `fly.main` with its default structure (BVH), against the same
        # run on the plain versions: equal PNGs.
        script = os.path.join(tmp, "events.jsonl")
        with open(script, "w") as f:
            for frame, evs in events.items():
                for ev in evs:
                    f.write(json.dumps({"frame": frame, **ev}) + "\n")
        argv = ["--model", path, "--script", script, "--frames",
                str(FLY_FRAMES), "--size", str(fly_size)]
        reset()
        check(fly.main(argv + ["--out", os.path.join(tmp, "fly")]) == 0,
              "fly.main failed")
        sync()
        got = counts()
        check(got["beam"] > 0, "fly.main: kernel L never launched")
        for k in ("beam", "walk_any", "walk_closest"):
            launches[k] += got[k]
        with PlainOnCard(plain):
            check(fly.main(argv + ["--out", os.path.join(tmp, "fly_plain")])
                  == 0, "fly.main (plain) failed")
        names = sorted(os.listdir(os.path.join(tmp, "fly")))
        check(len(names) == FLY_FRAMES, f"fly.main wrote {names}")
        hit = 0.0
        for png in names:
            k = read_png(os.path.join(tmp, "fly", png))
            check(np.array_equal(k, read_png(os.path.join(tmp, "fly_plain",
                                                          png))),
                  f"fly.main {png} differs from the plain path's")
            hit = max(hit, float((k != k[0, 0]).any(axis=-1).mean()))
        check(hit > 0.0, "fly.main: the model is not in view")
        print(f"fly.main (default --accel, BVH): {len(names)} frames equal "
              f"to the plain path's, launches {got}, up to {hit:.4f} of "
              f"pixels off the background")
        clock.done("28 (fly loop)")
    return launches


# The BVH path: the bench frame's scene and camera; the wavefront's frame
# edge; the frame edge of kernel L's check at tiles of 2x2 and 3x3; the
# FP32 operations of kernel K's slab test (6 subtractions, 6 multiplies, 6
# pairwise min/max, 4 more to reduce them, the clamp at 0) and of kernel
# L's node test (5 planes of 3 subtractions, 3 multiplies and
# 2 adds; the gap's 6 subtractions, 6 clamps and 3 adds; its square's 3
# multiplies and 2 adds; tile_tmax squared), comparisons not counted.
WAVEFRONT_SIZE = 256
SMALL_TILE_FRAME = 48
SLAB_OPS = 23
BEAM_NODE_OPS = 61
BVH_SOURCE = "raytracercuda_torch/csrc/bvh.cu"
# Kernel L's C entry launches these (phase 37 splits its time by them).
BEAM_KERNELS = ("beam_walk_kernel", "beam_test_kernel",
                "beam_epilogue_kernel")
# The chain-floor probe: dependent loads a run, and the tables it chases
# (rows of 32 bytes, as the node table's): one that stays in L1, and one of
# the bench tree's node count, which L2 holds.
CHASE_STEPS = 200_000
CHASE_L1_ROWS = 1024
# Queue entries a work item of kernel L's test, swept in phase 37.
BEAM_CHUNKS = (1, 2, 4, 8)


def random_tris(num_faces: int, seed: int, spread=1.5, z_shift=3.0):
    """``num_faces`` small random triangles in front of the origin, as
    `tests/test_torch_bvh.py:random_mesh` builds them: numpy ``(positions
    [3F, 3], faces [F, 4])``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (num_faces, 3)).astype(np.float32)
    base[:, 2] += z_shift
    offs = rng.normal(scale=0.3, size=(num_faces, 2, 3)).astype(np.float32)
    verts = np.concatenate([base[:, None], base[:, None] + offs],
                           axis=1).reshape(-1, 3)
    faces = np.arange(num_faces * 3, dtype=np.int64).reshape(-1, 3)
    return verts, np.concatenate([faces, np.zeros((num_faces, 1),
                                                  np.int64)], 1)


def big_tris(count: int):
    """``count`` large triangles dead ahead, one behind the other
    (`tests/test_torch_bvh.py:big_triangles`)."""
    import numpy as np

    tri = np.array([[-2, -2, 3], [2, -2, 3], [0, 2.5, 3]], np.float32)
    verts = np.concatenate([tri + [0.3 * i, 0.1 * i, 0.5 * i]
                            for i in range(count)]).astype(np.float32)
    faces = np.concatenate([np.arange(3 * count).reshape(-1, 3),
                            np.zeros((count, 1), int)], 1).astype(np.int64)
    return verts, faces


def doubled(mesh):
    """Every face of ``mesh`` twice, on the same vertices: each hit is an
    exact-t tie between a face and its copy."""
    import numpy as np

    verts, faces = mesh
    return verts, np.concatenate([faces, faces])


# Phase 33b's LBVH cases: name -> (mesh, max_leaf_faces, frame side,
# tile_px, queue).  Queue 4 overflows into many rounds; 2 and 9 faces at
# max_leaf_faces 16 leave the tree without traversal leaves (a-link -1,
# first = -1, the beam's row and slot rules part); the doubled clouds tie.
BVH_CASES = {
    "f120_queue4_overflow": (lambda: random_tris(120, 32), 4, 32, 8, 4),
    "f200_leaf1_queue4": (lambda: random_tris(200, 35), 1, 32, 8, 4),
    "two_faces_first_minus_1": (lambda: big_tris(2), 16, 32, 8, 128),
    "nine_faces_first_minus_1": (lambda: random_tris(9, 40, spread=0.6),
                                 16, 32, 8, 128),
    "f60_doubled_ties": (lambda: doubled(random_tris(60, 34)), 4, 32, 8, 16),
    "f300_doubled_ties_leaf1": (lambda: doubled(random_tris(300, 3)), 1, 64,
                                16, 8),
}


def bvh_cases(dev) -> None:
    """Phase 33b: kernel L, and K (closest and any hit), against their plain
    versions on `BVH_CASES`: slots equal, t/u/v bit-equal, masks equal; L's
    t equal to K's.  The doubled clouds must tie on every hit."""
    import numpy as np
    import torch

    from raytracercuda_torch.accel.bvh import build_bvh
    from raytracercuda_torch.config import BvhConfig
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import beam, traverse
    from raytracercuda_torch.trace.dense import (tile_frustum_planes,
                                                 tile_pixels)

    t_eps = np.float32(1e-4)
    for name, (mesh, leaf, side, tp, queue) in BVH_CASES.items():
        verts, faces = mesh()
        cfg = BvhConfig(max_leaf_faces=leaf)
        bvh = build_bvh(torch.from_numpy(verts).to(dev),
                        torch.from_numpy(faces).to(dev), cfg)
        eye = torch.zeros(3, device=dev)
        dirs = camera_ray_grid(side, side, device=dev).contiguous()
        planes = tile_frustum_planes(tile_pixels(dirs, side, side, tp),
                                     tp).contiguous()
        l_args = (bvh, eye, dirs, planes, side, side, tp, queue, leaf,
                  beam.walk_steps(cfg.max_iters), t_eps, 8)
        st = {}
        kl = beam._beam_cuda(*l_args, stats=st)
        hits, _ = closest_err(kl, beam._beam_plain(*l_args),
                              f"kernel L on {name}")
        origin = eye.expand(dirs.shape).contiguous()
        k_args = (bvh, origin, dirs, cfg.max_iters, t_eps)
        kk = traverse._walk_closest_cuda(*k_args)
        closest_err(kk, traverse._walk_closest_plain(*k_args),
                    f"kernel K (closest hit) on {name}")
        check(bits_equal(kl[0], kk[0]), f"{name}: L's t differs from K's")
        rng = np.random.default_rng(7)
        n = 4096
        so = torch.from_numpy((rng.uniform(-2, 2, (n, 3)) + [0, 0, 3])
                              .astype(np.float32)).to(dev)
        sd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)
                              ).to(dev)
        tm = torch.from_numpy(rng.uniform(0.5, 4.0, n).astype(np.float32)
                              ).to(dev)
        a_args = (bvh, so, sd, tm, cfg.max_iters, t_eps)
        ka = traverse._walk_any_cuda(*a_args)
        occlusion_err(ka, traverse._walk_any_plain(*a_args),
                      f"kernel K (any hit) on {name}")
        check(hits > 0 and 0 < int(ka.sum()) < n, f"{name}: no hit or every "
              "ray occluded")
        ties = ""
        if "doubled" in name:
            # Both copies of each hit face give the winner's t: the first
            # in sequence order won.
            f = bvh.face_order.shape[0] // 2
            hit = kl[0] < float(3.4028234663852886e38)
            twin = (bvh.face_order[kl[3][hit].long()] + f) % (2 * f)
            t_twin = traverse.row_mt(
                bvh.packed_tris[torch.argsort(bvh.face_order)[twin]], eye,
                dirs[hit], t_eps)[0]
            check(bits_equal(t_twin, kl[0][hit]),
                  f"{name}: a winner's copy gives another t")
            ties = f", {int(hit.sum())} exact-t ties"
        print(f"  {name}: {faces.shape[0]} faces, leaf {leaf}, queue "
              f"{queue}, "
              f"{side}x{side} in {tp}x{tp} tiles: L equal to plain in "
              f"{st['rounds']} rounds ({st['launched']} launched, "
              f"{st['syncs']} host syncs), "
              f"{hits} hits{ties}; K closest and any hit equal to plain "
              f"({int(ka.sum())} of {n} occluded)")


def chase_ns(dev, rows: int, steps: int = CHASE_STEPS) -> float:
    """Nanoseconds per dependent load: one thread follows a random cycle
    through ``rows`` rows of 32 bytes (`rt_chase`), warmed first, timed by
    events over ``steps`` loads."""
    import numpy as np
    import torch

    from raytracercuda_torch.ops.cuda_build import kernel_fn, raw_stream

    order = np.random.default_rng(3).permutation(rows)
    nxt = np.zeros(rows * 8, np.int32)
    nxt[order * 8] = np.roll(order, -1) * 8
    table = torch.from_numpy(nxt).to(dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)

    def run(n):
        err = kernel_fn("rt_chase")(table.data_ptr(), int(order[0]) * 8, n,
                                    out.data_ptr(), raw_stream(dev))
        check(err == 0, f"rt_chase launch failed: CUDA error {err}")

    run(rows)  # every row once: the table is in the caches
    return time_cuda(lambda: run(steps), 3) * 1e6 / steps


def parent_build(tree: str):
    """The `ops/cuda_build.py` module of the tree ``tree`` (an unpacked
    parent commit), loaded under another name: its `load_library` builds
    the parent's own sources into its own `_build/`."""
    import importlib.util

    path = os.path.join(tree, "raytracercuda_torch", "ops", "cuda_build.py")
    check(os.path.exists(path), f"--parent {tree}: no {path}")
    spec = importlib.util.spec_from_file_location("parent_cuda_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_grid_fn(lib):
    """The parent's kernel M, called as this tree's `_march_cuda`: where
    the parent's `rt_grid_march` has this tree's signature, through
    `_march_cuda` with the parent's entry in place of this tree's (the
    hints kept; the staged eye rows laid out as this tree lays them out);
    else the first design's C entry, one thread a ray over `march_rows`,
    which the parent builds the same way (the hints dropped)."""
    import torch

    from raytracercuda_torch.ops.cuda_build import SIGNATURES, raw_stream
    from raytracercuda_torch.trace import grid_march

    if len(lib.rt_grid_march.argtypes) == len(SIGNATURES["rt_grid_march"]):
        def same_form(*args):
            saved = grid_march.kernel_fn
            grid_march.kernel_fn = lambda name: getattr(lib, name)
            try:
                return grid_march._march_cuda(*args)
            finally:
                grid_march.kernel_fn = saved

        return same_form

    def march(rows, cell_start, num_cells, cell_res, pinch, origin,
              direction, max_iters, max_faces, t_eps, *hints):
        n, dev = direction.shape[0], direction.device
        out = torch.empty((3, n), device=dev)
        slot = torch.empty(n, dtype=torch.int32, device=dev)
        err = lib.rt_grid_march(
            cell_start.data_ptr(), num_cells, rows.data_ptr(), rows.shape[0],
            origin.data_ptr(), direction.data_ptr(), n, cell_res, pinch,
            max_iters, max_faces, int(t_eps is not None),
            0.0 if t_eps is None else float(t_eps), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), slot.data_ptr(),
            raw_stream(dev))
        check(err == 0, f"parent's M failed: CUDA error {err}")
        return out[0], out[1], out[2], slot

    return march


def beam_work(stats, num_slots: int, size: int, tp: int, queue: int,
              k_leaf: int, out):
    """Kernel L's per-round scratch read back (`_beam_cuda`'s ``stats``):
    each round's items held against `beam.split_queue`, each hit's key
    decoded to its round, entry and k and its slot (`candidate_row_slot`)
    held against the output slot.  Returns ``(tests per tile [T], items
    per round)``."""
    import torch

    from raytracercuda_torch.trace import beam
    from raytracercuda_torch.trace.dense import tile_pixels

    num_tiles = (size // tp) ** 2
    ws = stats["log"]
    dev = ws.device
    cand = torch.zeros(num_tiles, dtype=torch.int64, device=dev)
    items_per_round = []
    firsts = []
    for r in range(ws.shape[0]):
        q_first, q_count, q_n, items = beam.round_views(
            ws[r], num_tiles, queue, stats["item_cap"])
        want = beam.split_queue(q_n, beam.BEAM_CHUNK)
        m = want.shape[1]
        got = items[:, :m].long()
        got = got[:, torch.argsort(got[0] * (queue + 1) + got[1])]
        check(torch.equal(got, want), f"kernel L round {r}: work items "
              "differ from split_queue's")
        live = torch.arange(queue, device=dev) < q_n[:, None]
        cand += (torch.clamp(q_count, max=k_leaf) * live).sum(dim=1)
        items_per_round.append(m)
        firsts.append(q_first)
    # The kernel's unsigned keys in an int64 tensor: flipping the top bit
    # gives `beam_key`'s signed order.
    keys = stats["keys"].view(num_tiles, tp * tp) ^ -(1 << 63)
    hit = keys < beam.beam_key(
        torch.tensor([3.4028234663852886e38], device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev))
    rnd, entry, k = beam.ordinal_entry(keys & 0xFFFFFFFF, queue)
    tiles = torch.arange(num_tiles, device=dev)[:, None].expand(keys.shape)
    first = torch.stack(firsts)[rnd.clamp(max=len(firsts) - 1), tiles,
                                entry]
    _, slot = beam.candidate_row_slot(first, k, num_slots)
    want = tile_pixels(out[3], size, size, tp)
    check(torch.equal(slot[hit].int(), want[hit]),
          "kernel L's keys decode to other slots than its output's")
    return cand * tp * tp, items_per_round


def bvh_path(dev, clock, card, data, eye, orient, rays, size=SIZE,
             wf_size=WAVEFRONT_SIZE, api_size=C2_SIZE,
             suzanne_faces=C2_SUZANNE):
    """Phases 31-37: the LBVH backend on the bench frame's scene (``data``,
    ``eye``, ``orient``, ``rays`` of ``size``²) and on config 2's scene
    through `Scene.create()` with no config.  Returns the kernels' records
    (K closest, K any hit, L; launches of this path only) and the BVH
    frame's milliseconds."""
    import numpy as np
    import torch

    from raytracercuda_torch.accel.bvh import build_bvh
    from raytracercuda_torch.accel.stats import bvh_stats
    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import beam, bruteforce, pipeline, traverse
    from raytracercuda_torch.trace.dense import (tile_frustum_planes,
                                                 tile_pixels)
    from raytracercuda_torch.trace.frame import FrameRenderer
    from raytracercuda_torch.trace.wavefront import trace_wavefront

    flt_max = float(3.4028234663852886e38)
    launches = {"walk_closest": 0, "walk_any": 0, "beam": 0}

    def reset():
        traverse.reset_launch_counts()
        beam.reset_launch_counts()
        bruteforce.reset_launch_counts()

    def read(*need):
        """The counts since `reset`, added to this path's launches; each
        kernel of ``need`` must have launched."""
        sync_device(dev)
        c = {**traverse.launch_counts, **beam.launch_counts}
        for k in need:
            check(c[k] > 0, f"BVH path: kernel {k} never launched")
        for k in launches:
            launches[k] += c[k]
        return c

    plain_all = {beam: {"_beam_cuda": beam._beam_plain},
                 traverse: {"_walk_closest_cuda": traverse._walk_closest_plain,
                            "_walk_any_cuda": traverse._walk_any_plain},
                 bruteforce: {"_brute_cuda": bruteforce._brute_plain}}

    config = RenderConfig()
    check(config.accel is AccelKind.BVH, "the default structure is not BVH")
    tc, bc = config.trace, config.bvh
    t_eps = np.float32(tc.t_epsilon)

    # 31. The build on the card, held bitwise against the CPU's.
    build_ms = time_cuda(lambda: build_bvh(data.positions, data.faces, bc),
                         5)
    bvh = build_bvh(data.positions, data.faces, bc)
    host = build_bvh(data.positions.cpu(), data.faces.cpu(), bc)
    for name in bvh._fields:
        k, p = getattr(bvh, name).cpu(), getattr(host, name)
        same = (bits_equal(k, p) if p.dtype == torch.float32
                else torch.equal(k, p))
        check(same, f"build_bvh on the card: {name} differs from the CPU's")
    st = bvh_stats(bvh)
    print(f"BVH build: {data.num_faces} faces -> {st['nodes']} nodes, "
          f"{st['leaves']} leaves, leaf depth p50 {st['leaf_depth']['p50']} "
          f"p99 {st['leaf_depth']['p99']} max {st['leaf_depth']['max']}, "
          f"faces per leaf mean {st['faces_per_leaf']['mean']}; "
          f"{build_ms:.4f} ms on {card}; every field bitwise equal to the "
          "CPU build")
    clock.done("31 (BVH build)")

    # 32. K (closest hit) on the primary rays, through `trace_bvh`, and on
    # a scattered bundle through `trace_hit`.
    n = size * size
    dirs = pipeline.rotate_rays(rays, orient).contiguous()
    origin = eye[None, :].expand(dirs.shape).contiguous()
    bo, bd = scattered_bundle(dev, data.positions.amin(dim=0),
                              data.positions.amax(dim=0), BUNDLE_RAYS, 5)
    reset()
    walk_hit = traverse.trace_bvh(bvh, data.positions, data.faces, origin,
                                  dirs, bc, tc)
    bundle_hit = pipeline.trace_hit(data, bvh, bo, bd, config)
    read("walk_closest")
    k_args = (bvh, origin, dirs, bc.max_iters, t_eps)
    kk = traverse._walk_closest_cuda(*k_args)
    pk, k_plain_ms = time_once(
        lambda: traverse._walk_closest_plain(*k_args))
    hits, _ = closest_err(kk, pk, "kernel K (closest hit)")
    k_face = traverse.slot_hit(bvh, *kk).face
    check(torch.equal(walk_hit.face, k_face), "trace_bvh's faces differ")
    pb = traverse._walk_closest_plain(bvh, bo, bd, bc.max_iters, t_eps)
    check(torch.equal(bundle_hit.face, traverse.slot_hit(bvh, *pb).face),
          "kernel K on the bundle: faces differ from plain")
    e_hit = bruteforce.trace_brute(data.positions, data.faces, origin, dirs,
                                   tc)
    ties = k_face != e_hit.face
    check(bits_equal(e_hit.t, kk[0]), "kernel K's t differs from kernel E's "
          f"on {int((e_hit.t != kk[0]).sum())} rays")
    print(f"kernel K (closest hit) matches plain: {hits} of {n} rays hit, "
          f"slots equal, t/u/v bit-equal; the {BUNDLE_RAYS}-ray bundle "
          f"through trace_hit equal to plain; against kernel E t bit-equal "
          f"everywhere, {int(ties.sum())} pixels differ in face only by an "
          f"exact-t tie (E takes the lowest face id, the walk the lowest "
          f"Morton slot)")
    clock.done("32 (K closest)")

    # 33. L through `trace_hit` on the frame.
    reset()
    beam_hit = pipeline.trace_hit(data, bvh, origin, dirs, config,
                                  frame_hw=(size, size), common_origin=eye)
    read("beam")
    tp = tc.beam_tile
    planes = tile_frustum_planes(tile_pixels(dirs, size, size, tp),
                                 tp).contiguous()
    l_args = (bvh, eye, dirs, planes, size, size, tp, tc.beam_queue,
              bc.max_leaf_faces, beam.walk_steps(bc.max_iters), t_eps,
              tc.beam_tiles_per_chunk)
    l_stats = {}
    kl = beam._beam_cuda(*l_args, stats=l_stats)
    pl, l_plain_ms = time_once(lambda: beam._beam_plain(*l_args))
    closest_err(kl, pl, "kernel L")
    tile_tests, l_items = beam_work(l_stats, bvh.packed_tris.shape[0], size,
                                    tp, tc.beam_queue, bc.max_leaf_faces,
                                    kl)
    busy = tile_tests[tile_tests > 0].double()
    print(f"kernel L's work: {l_stats['rounds']} rounds "
          f"({l_stats['launched']} launched), {l_stats['syncs']} host "
          f"syncs a call; work items of "
          f"{beam.BEAM_CHUNK} queue entries per round {l_items} (each "
          f"round's equal to split_queue's; every hit's key decodes to its "
          f"slot); {busy.numel()} of {tile_tests.numel()} tiles test "
          f"triangles, {int(tile_tests.sum())} ray-triangle tests, per "
          f"such tile max {int(busy.max())}, mean {float(busy.mean()):.1f}")
    del l_stats
    check(torch.equal(kl[3], kk[3]) and bits_equal(kl[0], kk[0]),
          "kernel L's slots or t differ from kernel K's")
    check(torch.equal(beam_hit.face, k_face), "trace_hit's beam faces differ")
    # Tiles of fewer than 15 pixels: their blocks load the 15 plane floats
    # in a strided loop.
    sf = SMALL_TILE_FRAME
    small_dirs = pipeline.rotate_rays(camera_ray_grid(sf, sf, device=dev),
                                      orient).contiguous()
    small_hits = []
    for stp in (2, 3):
        s_args = (bvh, eye, small_dirs, tile_frustum_planes(
            tile_pixels(small_dirs, sf, sf, stp), stp).contiguous(), sf, sf,
            stp) + l_args[7:]
        small_hits.append(closest_err(
            beam._beam_cuda(*s_args), beam._beam_plain(*s_args),
            f"kernel L at {stp}x{stp} tiles")[0])
    print(f"kernel L matches plain: slots equal, t/u/v bit-equal, slots and "
          f"t equal to kernel K's; {size // tp}x{size // tp} tiles of "
          f"{tp}x{tp}, queue {tc.beam_queue}; also on {sf}x{sf} rays in "
          f"tiles of 2x2 and 3x3 ({small_hits} hits)")
    clock.done("33 (L)")

    # 33b. K and L on small trees that take many rounds, have no traversal
    # leaves (first = -1) or tie exactly.
    print("kernels K and L on synthetic trees:")
    bvh_cases(dev)
    clock.done("33b (K, L cases)")

    # 34. K (any hit) on the frame's shadow rays, by render_grad's rule.
    light = torch.tensor([0.4, 0.8, -0.45], device=dev)
    light = light / torch.sqrt(torch.sum(light * light))
    hit_mask = k_face >= 0
    p = origin + dirs * torch.clamp(kk[0], max=1e6)[:, None]
    so = (torch.where(hit_mask[:, None], p, origin)
          + light * (10 * tc.t_epsilon)).contiguous()
    sd = light.expand(dirs.shape).contiguous()
    reset()
    occ = traverse.any_hit_bvh(bvh, data.positions, data.faces, so, sd,
                               flt_max, bc, tc)
    read("walk_any")
    a_args = (bvh, so, sd, torch.full((n,), flt_max, device=dev),
              bc.max_iters, t_eps)
    ka = traverse._walk_any_cuda(*a_args)
    pa, a_plain_ms = time_once(lambda: traverse._walk_any_plain(*a_args))
    a_err = occlusion_err(ka, pa, "kernel K (any hit)")
    check(torch.equal(occ, ka), "any_hit_bvh's mask differs")
    check(torch.equal(ka, bruteforce.any_hit_brute(
        data.positions, data.faces, so, sd, flt_max, tc)),
        "kernel K (any hit) differs from any_hit_brute")
    print(f"kernel K (any hit) matches plain and any_hit_brute: "
          f"{int((ka & hit_mask).sum())} of {int(hit_mask.sum())} hit "
          f"pixels in shadow, {int(ka.sum())} occluded rays in all")
    clock.done("34 (K any hit)")

    # 35. The wavefront (plain PyTorch on the card).
    wd = pipeline.rotate_rays(camera_ray_grid(wf_size, wf_size, device=dev),
                              orient).contiguous()
    wo = eye[None, :].expand(wd.shape).contiguous()
    wf, wf_ms = time_once(lambda: trace_wavefront(
        bvh, data.positions, data.faces, wo, wd, bc, tc))
    wk = traverse.slot_hit(bvh, *traverse._walk_closest_cuda(
        bvh, wo, wd, bc.max_iters, t_eps))
    check(torch.equal(wf.face, wk.face),
          f"wavefront faces differ from kernel K's on "
          f"{int((wf.face != wk.face).sum())} rays")
    print(f"wavefront at {wf_size}x{wf_size}: faces equal to kernel K's, "
          f"{wf_ms:.1f} ms")
    clock.done("35 (wavefront)")

    # 36. The public API's default structure: Scene.create() with no
    # config, config 2's scene, Camera.trace_scene (kernel L); then the
    # FrameRenderer's BVH route with shadows on the bench frame.
    scene2, cam, target, eye2, orient2 = config2_scene(
        dev, api_size, suzanne_faces, default_structure=True)
    check(scene2.config.accel is AccelKind.BVH,
          "Scene.create() did not pick BVH")
    reset()
    check(cam.trace_scene(eye2, orient2, scene2, target) == 0,
          "trace_scene on the default structure")
    read("beam")
    api_frame = target.buffer.clone()
    frame_bits(api_frame, "API frame")
    with PlainOnCard(plain_all):
        check(cam.trace_scene(eye2, orient2, scene2, target) == 0,
              "trace_scene on the plain versions")
        sync_device(dev)
    check(torch.equal(api_frame, target.buffer),
          "default-structure frame differs from the plain path's")
    api_ms = time_cuda(lambda: cam.trace_scene(eye2, orient2, scene2,
                                               target), 20)
    check(target.unlock() == 0, "unlock")
    renderer = FrameRenderer(data, bvh, config, size, size)
    reset()
    frame = renderer.render(eye, orient, rays)
    read("beam", "walk_any")
    check(bruteforce.launch_counts["brute"] == 0,
          "BVH frame: kernel E launched; shadows should walk the LBVH")
    with PlainOnCard(plain_all):
        plain_frame = renderer.render(eye, orient, rays)
        sync_device(dev)
    worst = u8_diff(frame, plain_frame)
    check(worst <= 1, f"BVH frame vs plain frame: u8 diff {worst}")
    frame_ms = time_cuda(lambda: renderer.render(eye, orient, rays), 10)
    print(f"Scene.create() (no config) -> {scene2.config.accel}: "
          f"{api_size}x{api_size} frame equal to the plain path's, "
          f"{int((api_frame != 255 << 8).sum())} pixels hit, "
          f"Camera.trace_scene {api_ms:.4f} ms a frame; FrameRenderer "
          f"BVH route with shadows at {size}x{size}: max u8 diff {worst} to "
          f"the plain path, {frame_ms:.4f} ms/frame, "
          f"{n / frame_ms * 1e3:.6g} rays/s (W*H per frame) on {card}")
    clock.done("36 (default structure, BVH frame)")

    # Times and bounds: the work each function needs on these inputs, from
    # instrumented plain runs of the walk.  L computes the same closest
    # hits on the same rays as K (phase 33 holds its slots and t to K's),
    # and its candidates are chosen inside the kernel, not given to it, so
    # its bound is K's work with L's own inputs and outputs; the beam's
    # own tests are printed beside it.  Bytes: each input and output once,
    # and of the tree only the node and triangle rows the walk reads.
    tallies = []
    for fn, args in ((traverse._walk_closest_plain, k_args),
                     (traverse._walk_any_plain, a_args),
                     (beam._beam_plain, l_args)):
        tally = {"box_tests": 0, "tri_tests": 0}
        fn(*args, tally=tally)
        tallies.append(tally)

    def walk_work(tally, *io):
        node_row = nbytes(bvh.packed_nodes[:1], bvh.packed_links[:1])
        tri_row = nbytes(bvh.packed_tris[:1])
        return (tally["tri_tests"] * MT_OPS + tally["box_tests"] * SLAB_OPS
                + 3 * n,
                int(tally["touched_nodes"].sum()) * node_row
                + int(tally["touched_rows"].sum()) * tri_row + nbytes(*io))

    work = [walk_work(tallies[0], origin, dirs, kk),
            walk_work(tallies[1], *a_args[1:4], ka),
            walk_work(tallies[0], eye, dirs, planes, kl)]
    for name, tally in (("K closest", tallies[0]), ("K any hit", tallies[1])):
        print(f"kernel {name} reads {int(tally['touched_nodes'].sum())} of "
              f"{bvh.packed_nodes.shape[0]} nodes and "
              f"{int(tally['touched_rows'].sum())} of "
              f"{bvh.packed_tris.shape[0]} triangle rows")
    print(f"kernel L's own work (the tile beam's, above the bound's): "
          f"{tallies[2]['tri_tests']} ray-triangle tests, "
          f"{tallies[2]['box_tests']} node tests of {BEAM_NODE_OPS} "
          f"operations")
    # The longest walks, and the chain floor: the longest walk's steps,
    # each one dependent load.
    floor_ns = {"L1": chase_ns(dev, CHASE_L1_ROWS),
                "L2": chase_ns(dev, bvh.packed_nodes.shape[0])}
    for name, tally in (("K closest", tallies[0]), ("K any hit", tallies[1])):
        steps = tally["ray_steps"]
        far = int(torch.argmax(steps))
        print(f"kernel {name}: longest walk {int(steps.max())} steps (ray "
              f"{far}, {int(tally['ray_tri_tests'][far])} ray-triangle "
              f"tests), most tests of a ray "
              f"{int(tally['ray_tri_tests'].max())}; chain floor "
              + ", ".join(f"{int(steps.max()) * ns / 1e6:.6f} ms at "
                          f"{ns:.1f} ns a load ({where}-resident chase)"
                          for where, ns in floor_ns.items()))
    # K on the same tree with its node rows in the build's order (links as
    # built): what the walk order gives K.
    built = (torch.cat([bvh.packed_nodes.view(torch.int32),
                        bvh.packed_links], dim=1).contiguous(),
             traverse.kernel_rows(bvh)[1])
    with PlainOnCard({traverse: {"kernel_rows": lambda _: built}}):
        closest_err(traverse._walk_closest_cuda(*k_args), kk,
                    "kernel K on node rows in the build's order")
        check(torch.equal(traverse._walk_any_cuda(*a_args), ka),
              "kernel K (any hit) on node rows in the build's order")
        in_built = [time_cuda(lambda: traverse._walk_closest_cuda(*k_args),
                              20),
                    time_cuda(lambda: traverse._walk_any_cuda(*a_args), 20)]
    in_walk = [time_cuda(lambda: traverse._walk_closest_cuda(*k_args), 20),
               time_cuda(lambda: traverse._walk_any_cuda(*a_args), 20)]
    print(f"kernel K by events, node rows in walk order: closest "
          f"{in_walk[0]:.4f} ms, any hit {in_walk[1]:.4f}; in the build's "
          f"order: {in_built[0]:.4f}, {in_built[1]:.4f} (equal outputs)")
    fns = [(lambda: traverse._walk_closest_cuda(*k_args), ("walk_kernel",)),
           (lambda: traverse._walk_any_cuda(*a_args), ("walk_kernel",)),
           (lambda: beam._beam_cuda(*l_args), BEAM_KERNELS)]
    names = [("walk_closest", "raytracercuda_tpu/trace/traverse.py:62",
              k_plain_ms, 0.0),
             ("walk_any", "raytracercuda_tpu/trace/traverse.py:163",
              a_plain_ms, a_err),
             ("beam", "raytracercuda_tpu/trace/beam.py:121", l_plain_ms,
              0.0)]
    records = []
    for (name, replaces, plain_ms, err), (fn, kernel), (o, m), tally in zip(
            names, fns, work, tallies):
        ms = time_cuda(fn, 20)
        dev_ms, _, recorded = device_ms(fn, 20, kernel)
        hidden = time_queued(fn, 20)
        records.append(kernel_record(name, BVH_SOURCE, replaces,
                                     launches[name], err, ms, plain_ms,
                                     bound(o, m), device_ms=dev_ms))
        print(f"kernel {name}: {ms:.4f} ms a launch by events, "
              f"{ms_text(dev_ms)} on the card (profiler, {recorded} of 20 "
              f"launches recorded), host hidden {ms_text(hidden)}, plain "
              f"{plain_ms:.1f} ms on the card; bound {o:.0f} operations, "
              f"{m} bytes; its own {tally['tri_tests']} ray-triangle "
              f"tests, {tally['box_tests']} node tests")
    acts = device_activities(fns[2][0], 20)
    split = {k: sum(ms for name, (ms, _) in acts.items()
                    if short_kernel_name(name) == k) for k in BEAM_KERNELS}
    rest = sum(ms for ms, _ in acts.values()) - sum(split.values())
    print("kernel L on the card by kernel (profiler, ms a call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; the rest {rest:.4f}")
    # L by queue entries a work item (`beam.BEAM_CHUNK`), each run equal
    # to the default's.
    chunk = beam.BEAM_CHUNK
    try:
        for c in BEAM_CHUNKS:
            beam.BEAM_CHUNK = c
            closest_err(beam._beam_cuda(*l_args), kl,
                        f"kernel L at {c} entries an item")
            acts = device_activities(fns[2][0], 20)
            by = [sum(ms for name, (ms, _) in acts.items()
                      if short_kernel_name(name) == k) for k in BEAM_KERNELS]
            print(f"kernel L at {c} queue entries a work item: "
                  f"{time_cuda(fns[2][0], 20):.4f} ms by events; on the "
                  f"card walk {by[0]:.4f}, test {by[1]:.4f}, epilogue "
                  f"{by[2]:.4f} ms")
    finally:
        beam.BEAM_CHUNK = chunk
    print(f"wavefront {wf_size}x{wf_size} (plain PyTorch): {wf_ms:.1f} ms; "
          f"BVH build {build_ms:.4f} ms; on {card}")
    clock.done("37 (BVH kernel times)")
    return records, frame_ms


# The GRID path: the card's hash-grid build and kernel M on the bench
# scene, config 2's scene through the public API, the render CLI.  The
# FP32 operations of one step of kernel M's march besides its tests
# (`csrc/grid.cu:march_kernel`): the cell's 3 divisions and 3 floors, the
# box's 3 products and 3 sums, the slab's 6 subtractions, 6 products and
# 10 NaN-propagating min/max, and the advance's 1 sum, 3 products and 3
# sums; the hash's integer operations and the comparisons not counted.
# Kernel M's dependent loads a step: the bucket's offsets, then its rows.
GRID_SOURCE = "raytracercuda_torch/csrc/grid.cu"
GRID_STEP_OPS = 41
GRID_STEP_LOADS = 2
# Rays of each synthetic case of phase 39 on the bench scene, and the frame
# edge of the render CLI's GRID runs (their plain path's march takes ~7 s a
# frame at 512x512 on the card).
GRID_CASE_RAYS = 512
GRID_CLI_SIZE = 128


def grid_work_text(tally) -> str:
    """The plain march's count of kernel M's work (`grid_march._tally_done`)
    for the log: lane use of one thread a ray on warps of consecutive rays
    and of 8x4 pixel patches, of the shared schedule, and rows read."""
    use = tally["serial_lane_use"]
    rows = tally["shared_rows"]
    return ("kernel M's work: lane use with one thread a ray "
            + ", ".join(f"{k} warps {v:.4f}" for k, v in use.items())
            + f", with a block's rays sharing each bucket's rows "
            f"{tally['shared_lane_use']:.4f}; rows read one a test "
            f"{tally['tests']}, each distinct bucket once a block-step "
            + ", ".join(f"{k} blocks {v}" for k, v in rows.items()))


def collision_scene():
    """`tests/test_grid.py:112`'s scene: a near face in cell (0,0,100) and
    a far face in cell (0,0,255), whose bucket is cell (0,0,0)'s, with
    axis-aligned rays, some from points on cell boundaries (0 * inf in the
    slab test): numpy ``(positions, faces, origins, directions)``."""
    import numpy as np

    f32 = np.float32

    def tri_at(z):
        return np.array([[0.002, 0.002, z], [0.028, 0.002, z],
                         [0.015, 0.028, z]], np.float32)

    pos = np.concatenate([tri_at(100 * f32(0.03) + f32(0.0015)),
                          tri_at(255 * f32(0.03) + f32(0.0015))])
    faces = np.array([[0, 1, 2, 0], [3, 4, 5, 0]], np.int64)
    o = np.array([[0.015, 0.012, 0.0005], [0.0, 0.0, -1.0], [0.03, 0.06, -1],
                  [0.03, -0.09, 0.0], [-0.2, 0.0, 0.0], [0.0, -0.2, 0.03]],
                 np.float32)
    d = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 0], [1, 0, 0],
                  [0, 1, 0]], np.float32)
    return pos, faces, o, d


def grid_cases(dev, data, grid, eye) -> None:
    """Phase 39's synthetic cases: kernel M against its plain version
    (slots equal, t/u/v bit-equal) on the collision scene, and on the bench
    scene's grid with axis-aligned and zero-component directions, rays
    that exhaust ``max_search_iters``, ``max_faces_per_cell`` = 4, and
    origins inside the mesh with ``clip_backward_hits`` on and off; the
    cases whose rays leave the eye also with the hints (a ragged frame and
    the staged eye terms)."""
    import numpy as np
    import torch

    from raytracercuda_torch.accel.grid import build_grid
    from raytracercuda_torch.config import GridConfig, TraceConfig
    from raytracercuda_torch.trace import grid_march

    flt_max = float(3.4028234663852886e38)
    rng = np.random.default_rng(11)
    n = GRID_CASE_RAYS
    lo = data.positions.amin(dim=0).cpu().numpy()
    hi = data.positions.amax(dim=0).cpu().numpy()
    centre, eye_np = (lo + hi) / 2, eye.cpu().numpy()
    axes = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)] * rng.choice(
        [-1.0, 1.0], (n, 1)).astype(np.float32)
    zero = rng.normal(size=(n, 3)).astype(np.float32)
    zero[np.arange(n), rng.integers(0, 3, n)] = 0.0
    on_cells = (np.round(rng.uniform(lo, hi, (n, 3)) / 0.03) * 0.03).astype(
        np.float32)
    inside = (centre + rng.normal(size=(n, 3)) * 0.3 * (hi - lo)).astype(
        np.float32)
    towards = (centre + rng.uniform(-0.5, 0.5, (n, 3)) * (hi - lo)
               - eye_np).astype(np.float32)
    cases = {  # name: (origins, dirs, GridConfig keywords, clip)
        "axis-aligned from cell corners": (on_cells, axes, {}, True),
        "zero components from the eye": (
            np.broadcast_to(eye_np, (n, 3)), zero, {}, True),
        "max_search_iters 40": (np.broadcast_to(eye_np, (n, 3)), towards,
                                dict(max_search_iters=40), True),
        "max_faces_per_cell 4": (np.broadcast_to(eye_np, (n, 3)), towards,
                                 dict(max_faces_per_cell=4), True),
        "inside, clip_backward_hits on": (inside, zero, {}, True),
        "inside, clip_backward_hits off": (inside, zero, {}, False),
    }
    # Cases of one configuration run as one call of each version (the
    # plain march's time is mostly its steps, not its rays).
    groups = {}
    for name, (o, d, kw, clip) in cases.items():
        groups.setdefault((tuple(sorted(kw.items())), clip), []).append(
            (name, o, d))
    runs = [(grid, data.positions, data.faces, dict(kw), clip, members)
            for (kw, clip), members in groups.items()]
    pos, faces, o, d = collision_scene()
    cp, cf = torch.from_numpy(pos).to(dev), torch.from_numpy(faces).to(dev)
    runs.append((build_grid(cp, cf), cp, cf, {}, True,
                 [("collision scene", o, d)]))
    for g, p, f, kw, clip, members in runs:
        cfg = GridConfig(**kw)
        tc = TraceConfig(clip_backward_hits=clip)
        o = np.concatenate([m[1] for m in members]).astype(np.float32)
        d = np.concatenate([m[2] for m in members]).astype(np.float32)
        args = grid_march.march_args(
            g, p, f, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            cfg, tc)
        tally = {}
        km = grid_march._march_cuda(*args)
        pm = grid_march._march_plain(*args, tally=tally)
        closest_err(km, pm, "kernel M (" + ", ".join(m[0] for m in members)
                    + ")")
        first = 0
        for name, mo, md in members:
            part = slice(first, first + mo.shape[0])
            first = part.stop
            t, steps = pm[0][part], tally["ray_steps"][part]
            hinted = ""
            if np.array_equal(mo, np.broadcast_to(eye_np, mo.shape)):
                # From the eye: again as a ragged frame (8x4 patches half
                # outside it) from the staged eye terms.
                frame = (mo.shape[0] // 4, 4)
                ho, hd = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                          for x in (mo, md))
                hm = grid_march._march_cuda(*grid_march.march_args(
                    g, p, f, ho, hd, cfg, tc, frame, eye))
                closest_err(hm, tuple(x[part] for x in pm),
                            f"kernel M ({name}, frame {frame}, staged eye)")
                hinted = (f"; equal as a {frame[0]}x{frame[1]} frame from "
                          "the staged eye")
            print(f"  {name}: {mo.shape[0]} rays, "
                  f"{int((t < flt_max).sum())} hits "
                  f"({int((t < 0).sum())} at a negative t), longest march "
                  f"{int(steps.max())} steps, "
                  f"{int((steps == cfg.max_search_iters).sum())} rays take "
                  f"all {cfg.max_search_iters}{hinted}")
        if members[0][0] == "collision scene":
            face = grid_march.slot_hit(g, *km).face
            check(int(face[0]) == 1, "kernel M: the collision case's ray "
                  "does not report the far face")


def grid_path(dev, clock, card, data, eye, orient, rays, size=SIZE,
              api_size=C2_SIZE, suzanne_faces=C2_SUZANNE,
              cli_size=GRID_CLI_SIZE, cli_faces=C2_SUZANNE, frames=3,
              parent=None):
    """Phases 38-41: the GRID backend on the bench frame's scene
    (``data``, ``eye``, ``orient``, ``rays`` of ``size``²), config 2's
    scene through `Scene.create(RenderConfig(accel=GRID))` and the render
    CLI's ``--accel grid``.  ``parent``: the directory of an unpacked
    parent commit, whose kernel M phase 41 times in turns with this
    tree's.  Returns kernel M's record (launches of this path only) and
    the GRID frame's milliseconds."""
    import tempfile

    import numpy as np
    import torch

    from raytracercuda_torch.accel.grid import HashGrid, build_grid
    from raytracercuda_torch.accel.stats import grid_stats
    from raytracercuda_torch.apps import render_cli
    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.trace import bruteforce, grid_march, pipeline
    from raytracercuda_torch.trace.frame import FrameRenderer
    from raytracercuda_torch.trace.shadow import (build_shadow_grid,
                                                  occlusion_grid)

    flt_max = float(3.4028234663852886e38)
    launches = 0

    def reset():
        grid_march.reset_launch_counts()
        bruteforce.reset_launch_counts()

    def read(where: str) -> None:
        """Add the launches of M since `reset` to this path's; M must have
        launched."""
        nonlocal launches
        sync_device(dev)
        got = grid_march.launch_counts["grid_march"]
        check(got > 0, f"GRID path ({where}): kernel M never launched")
        launches += got

    plain_all = {grid_march: {"_march_cuda": grid_march._march_plain},
                 bruteforce: {"_brute_cuda": bruteforce._brute_plain}}
    config = RenderConfig(accel=AccelKind.GRID)
    gc, tc = config.grid, config.trace

    # 38. The build on the card, held bitwise against the CPU's.
    build_ms = time_cuda(lambda: build_grid(data.positions, data.faces, gc),
                         3)
    grid = build_grid(data.positions, data.faces, gc)
    host = build_grid(data.positions.cpu(), data.faces.cpu(), gc)
    check(torch.equal(grid.cell_start.cpu(), host.cell_start)
          and torch.equal(grid.entries.cpu(), host.entries),
          "build_grid on the card differs from the CPU's")
    st = grid_stats(grid)
    per = st["faces_per_live_cell"]
    print(f"GRID build: {data.num_faces} faces -> {st['live_cells']} of "
          f"{st['cells']} buckets live, {st['entries']} entries, faces per "
          f"live bucket mean {per['mean']}, p50 {per['p50']}, p99 "
          f"{per['p99']}, max {per['max']}; {build_ms:.4f} ms on {card}; "
          "cell_start and entries bitwise equal to the CPU build")
    clock.done("38 (GRID build)")

    # 39. M through the FrameRenderer's GRID route (M, then shadows by E),
    # against the same frame on the plain versions; M's inputs recorded,
    # and the plain march's output and work captured in that frame.
    n = size * size
    renderer = FrameRenderer(data, grid, config, size, size)
    reset()
    rec = Recorder(grid_march, ["_march_cuda"])
    try:
        frame = renderer.render(eye, orient, rays)
        read("the GRID frame")
    finally:
        rec.restore()
    check(bruteforce.launch_counts["brute"] > 0,
          "GRID frame: kernel E (shadows) never launched")
    m_args = rec.calls["_march_cuda"][-1]
    check(m_args[10] == (size, size) and m_args[11] is not None,
          "the GRID frame's route gave kernel M no frame or eye")
    captured = {}

    def plain_march(*args):
        tally = {}
        out, ms = time_once(lambda: grid_march._march_plain(*args,
                                                            tally=tally))
        captured.update(out=out, ms=ms, tally=tally)
        return out

    with PlainOnCard({**plain_all, grid_march: {"_march_cuda": plain_march}}):
        plain_frame = renderer.render(eye, orient, rays)
        sync_device(dev)
    worst = u8_diff(frame, plain_frame)
    check(worst <= 1, f"GRID frame vs plain frame: u8 diff {worst}")
    km = grid_march._march_cuda(*m_args)
    hits, _ = closest_err(km, captured["out"],
                          "kernel M (the GRID frame: patches, staged eye)")
    closest_err(grid_march._march_cuda(*m_args[:10]), captured["out"],
                "kernel M (the GRID frame without hints)")
    tally = captured["tally"]
    steps, tests = tally["ray_steps"], tally["ray_tests"].double()
    print(f"kernel M matches plain on the GRID frame's {n} rays, on "
          f"{size}x{size} pixel patches from the staged eye and without "
          f"the hints: slots equal, t/u/v bit-equal; {hits} hit "
          f"({hits / n:.4f}), longest march {int(steps.max())} steps "
          f"({int((steps == gc.max_search_iters).sum())} rays take all "
          f"{gc.max_search_iters}), ray-triangle tests a ray "
          f"mean {float(tests.mean()):.1f}, p99 "
          f"{float(torch.quantile(tests, 0.99)):.0f}, max "
          f"{int(tests.max())}; {tally['steps']} steps, {tally['tests']} "
          f"tests in all; frame max u8 diff {worst} to the plain path")
    print(grid_work_text(tally))
    # A bundle with scattered origins through `trace_hit`.
    bo, bd = scattered_bundle(dev, data.positions.amin(dim=0),
                              data.positions.amax(dim=0), BUNDLE_RAYS, 5)
    reset()
    bundle_hit = pipeline.trace_hit(data, grid, bo, bd, config)
    read("the bundle")
    b_args = grid_march.march_args(grid, data.positions, data.faces, bo, bd,
                                   gc, tc)
    pb = grid_march._march_plain(*b_args)
    b_hits, _ = closest_err(grid_march._march_cuda(*b_args), pb,
                            "kernel M (the bundle)")
    check(torch.equal(bundle_hit.face, grid_march.slot_hit(grid, *pb).face),
          "trace_hit's GRID faces on the bundle differ from plain")
    print(f"kernel M on the {BUNDLE_RAYS}-ray bundle through trace_hit: "
          f"equal to plain, {b_hits} hits")
    print("kernel M on synthetic cases, each equal to plain:")
    grid_cases(dev, data, grid, eye)
    clock.done("39 (M vs plain)")

    # 40. The public API on GRID: config 2's scene, Camera.trace_scene (M),
    # equal to the plain path; hit pixels beside BRUTE's; the render CLI's
    # parity and lambert routes with --accel grid, PNGs equal to plain.
    scene2, cam, target, eye2, orient2 = config2_scene(
        dev, api_size, suzanne_faces, accel=AccelKind.GRID)
    check(isinstance(scene2.accel, HashGrid), "Scene.create(GRID) built "
          f"{type(scene2.accel).__name__}")
    reset()
    check(cam.trace_scene(eye2, orient2, scene2, target) == 0,
          "trace_scene on GRID")
    read("Camera.trace_scene")
    api_frame = target.buffer.clone()
    frame_bits(api_frame, "API frame")
    with PlainOnCard(plain_all):
        check(cam.trace_scene(eye2, orient2, scene2, target) == 0,
              "trace_scene on GRID, plain versions")
        sync_device(dev)
    check(torch.equal(api_frame, target.buffer),
          "GRID API frame differs from the plain path's")
    brute2, bcam, btarget, _, _ = config2_scene(dev, api_size, suzanne_faces)
    check(bcam.trace_scene(eye2, orient2, brute2, btarget) == 0,
          "trace_scene on BRUTE")
    check(btarget.unlock() == 0, "unlock")
    bg = 255 << 8
    g2 = scene2.accel
    kept = torch.bincount(g2.entries[:int(g2.cell_start[-1])].long(),
                          minlength=scene2.data().num_faces)[-2:].tolist()
    st2 = grid_stats(g2)
    print(f"Scene.create(GRID) on config 2's scene: {api_size}x{api_size} "
          f"frame equal to the plain path's, {int((api_frame != bg).sum())} "
          f"pixels hit against BRUTE's {int((btarget.buffer != bg).sum())} "
          f"(the quad's two faces keep {kept} of their cells: "
          f"max_cells_per_face truncates them, as in the JAX package); "
          f"{st2['live_cells']} live buckets, {st2['entries']} entries")
    cli_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = write_textured_obj(tmp, cli_faces, 64)
        common = ["--accel", "grid", "--size", str(cli_size), "--frames",
                  str(frames), "--orbit", "15"]
        for shading in ("parity", "lambert"):
            reset()
            check(render_cli.main([path, *common, "--shading", shading, "-o",
                                   os.path.join(tmp, shading)]) == 0,
                  f"render CLI --accel grid ({shading}) failed")
            read(f"render CLI {shading}")
            cli_launches[shading] = grid_march.launch_counts["grid_march"]
            with PlainOnCard(plain_all):
                check(render_cli.main([path, *common, "--shading", shading,
                                       "-o", os.path.join(tmp, shading + "_p")
                                       ]) == 0,
                      f"render CLI --accel grid ({shading}, plain) failed")
            for f in range(frames):
                png = f"frame_{f:04d}.png"
                k = read_png(os.path.join(tmp, shading, png))
                check(np.array_equal(k, read_png(
                    os.path.join(tmp, shading + "_p", png))),
                    f"render CLI --accel grid {shading} {png} differs from "
                    "the plain path's")
                check(bool((k != k[0, 0]).any()),
                      f"render CLI --accel grid {shading}: nothing in view")
        try:
            render_cli.main([path, *common, "--shading", "lambert-shadow",
                             "-o", os.path.join(tmp, "shadow")])
            fail("render CLI --accel grid lambert-shadow did not raise")
        except NotImplementedError:
            pass
    print(f"render CLI --accel grid at {cli_size}x{cli_size}, {frames} "
          f"frames each: parity and lambert PNGs equal to the plain path's, "
          f"launches of M {cli_launches}; lambert-shadow raises, as the JAX "
          "package's route does on a grid")
    clock.done("40 (public API on GRID)")

    # 41. Times and bound: M with the route's hints, on the patches
    # without the staged eye, without either hint, and in turns with the
    # parent's M.
    fn = lambda: grid_march._march_cuda(*m_args)  # noqa: E731
    m_ms = time_cuda(fn, 20)
    m_device_ms, _, recorded = device_ms(fn, 20, ("march_kernel",))
    variants = {}
    for name, args in (("pixel patches, the general test", m_args[:11]),
                       ("blocks of consecutive rays, the general test",
                        m_args[:10])):
        vf = lambda a=args: grid_march._march_cuda(*a)  # noqa: E731
        closest_err(vf(), km, f"kernel M ({name})")
        variants[name] = (time_cuda(vf, 20),
                          device_ms(vf, 20, ("march_kernel",))[0])
    print(f"kernel M on the GRID frame, ms a launch by events and on the "
          f"card, outputs equal: pixel patches from the staged eye (the "
          f"route's hints) {m_ms:.4f}, {ms_text(m_device_ms)}; "
          + "; ".join(f"{name} {ev:.4f}, {ms_text(dv)}"
                      for name, (ev, dv) in variants.items()))
    if parent is not None:
        old_fn = parent_grid_fn(parent_build(parent).load_library())
        closest_err(fn(), old_fn(*m_args), "kernel M against the parent")
        turns = [time_cuda(lambda: f(*m_args), 20)
                 for f in (old_fn, grid_march._march_cuda,
                           grid_march._march_cuda, old_fn)]
        dev_old = device_ms(lambda: old_fn(*m_args), 20,
                            ("march_kernel",))[0]
        print(f"kernel M against the parent ({parent}) on the GRID frame's "
              f"rays, equal outputs; by events parent, this, this, parent: "
              + ", ".join(f"{t:.4f}" for t in turns)
              + f" ms; on the card this {ms_text(m_device_ms)}, parent "
              f"{ms_text(dev_old)}")
    else:
        print("parent's kernel M: not timed (no --parent)")
    frame_ms = time_cuda(lambda: renderer.render(eye, orient, rays), 10)
    api_ms = time_cuda(lambda: cam.trace_scene(eye2, orient2, scene2,
                                               target), 20)
    check(target.unlock() == 0, "unlock")
    # occlusion_grid (plain PyTorch) on the GRID frame's shadow rays, by
    # the FrameRenderer's rule, against kernel E's any hit.
    light = renderer.light
    sgrid_ms = time_cuda(lambda: build_shadow_grid(data.positions,
                                                   data.faces, light), 3)
    sgrid = build_shadow_grid(data.positions, data.faces, light)
    hit = grid_march.slot_hit(grid, *km)
    dirs, origin = m_args[6], m_args[5]
    p = origin + dirs * torch.clamp(hit.t, max=1e6)[:, None]
    so = (torch.where(hit.hit_mask[:, None], p, origin)
          + light * renderer.shadow_eps).contiguous()
    occ = occlusion_grid(sgrid, so, hit.hit_mask, trace_cfg=tc)
    want = bruteforce.any_hit_brute(data.positions, data.faces, so,
                                    light.expand(so.shape).contiguous(),
                                    flt_max, tc) & hit.hit_mask
    check(torch.equal(occ, want), "occlusion_grid differs from kernel E's "
          f"any hit on {int((occ != want).sum())} rays")
    occ_ms = time_cuda(lambda: occlusion_grid(sgrid, so, hit.hit_mask,
                                              trace_cfg=tc), 5)
    # The bound: the plain march's work on the frame's rays; the bytes of
    # the rays, the outputs, and the buckets' offsets and rows read.
    ops = tally["tests"] * MT_OPS + tally["steps"] * GRID_STEP_OPS
    moved = (nbytes(m_args[5], m_args[6], *km) + tally["buckets_read"] * 8
             + tally["rows_read"] * 48)
    floor_ns = {"L1": chase_ns(dev, CHASE_L1_ROWS),
                "L2": chase_ns(dev, grid.num_cells)}
    far = int(steps.max())
    record = kernel_record("grid_march", GRID_SOURCE,
                           "raytracercuda_tpu/trace/grid_march.py:51",
                           launches, 0.0, m_ms, captured["ms"],
                           bound(ops, moved), device_ms=m_device_ms)
    print(f"kernel M: {m_ms:.4f} ms a launch by events, "
          f"{ms_text(m_device_ms)} on the card (profiler, {recorded} of 20 "
          f"launches recorded), plain {captured['ms']:.1f} ms on the card "
          f"(one run, counting its work); bound {record['bound_ms']:.6f} ms "
          f"by {record['bound_by']} ({ops} operations: {tally['tests']} "
          f"ray-triangle tests, {tally['steps']} steps; {moved} bytes: "
          f"{tally['buckets_read']} buckets, {tally['rows_read']} rows); "
          f"chain floor "
          + ", ".join(f"{far * GRID_STEP_LOADS * ns / 1e6:.6f} ms at "
                      f"{ns:.1f} ns a load ({where}-resident chase)"
                      for where, ns in floor_ns.items())
          + f" ({far} steps x {GRID_STEP_LOADS} dependent loads); "
          f"{launches} launches on this path; {grid_work_text(tally)}")
    print(f"GRID frame at {size}x{size} (M, shadows by E): "
          f"{frame_ms:.4f} ms/frame, {n / frame_ms * 1e3:.6g} rays/s (W*H "
          f"per frame); Camera.trace_scene on GRID at {api_size}x{api_size} "
          f"{api_ms:.4f} ms a frame; build_grid {build_ms:.4f} ms; "
          f"build_shadow_grid {sgrid_ms:.4f} ms, occlusion_grid "
          f"{occ_ms:.4f} ms on the frame's {int(hit.hit_mask.sum())} shadow "
          f"rays (plain PyTorch; masks equal to kernel E's); on {card}")
    clock.done("41 (GRID times)")
    return record, frame_ms


SIL_FD_SS = 64  # the supersampling of the finite-difference check (phase 43)
SIL_FD_SAMPLES = 2048  # edge samples of that check, as in the JAX test


def silhouette_path(dev, clock, card, c4, size=C4_SIZE, fd_ss=SIL_FD_SS):
    """Phases 42-43: `render_rgb_silhouette` on config 4's scene (CLUSTER:
    C for the frame, C's epilogue over F's sweep for the boundary probes, G
    in the backward) and the finite-difference check of the 9x9 flat
    triangle on BRUTE (kernel E).  Returns ``{record name: launches}``."""
    import numpy as np
    import torch

    from raytracercuda_torch import interop
    from raytracercuda_torch.config import AccelKind, DiffConfig, RenderConfig
    from raytracercuda_torch.diff import edge_grad, render_grad, scatter
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.trace import bounce_sweep, bruteforce, sweep
    from raytracercuda_torch.utils import profiler

    config, data, accel, eye, orient = c4
    n, hw = size * size, (size, size)
    t = time.perf_counter()
    edges = edge_grad.build_edge_table(data.faces)
    table_s = time.perf_counter() - t
    ev, ef = (torch.from_numpy(x).to(dev) for x in edges)
    rays = camera_ray_grid(size, size, device=dev)
    w = torch.from_numpy(np.random.default_rng(11).uniform(
        0.2, 1.0, (n, 3)).astype(np.float32)).to(dev)

    def step(silhouette=True):
        """The loss sum(img * w) and its gradients for the positions, the
        eye and the orientation: through `render_rgb_silhouette`, or
        through `render_rgb_vjp` (no boundary term)."""
        p, e, o = (x.detach().clone().requires_grad_()
                   for x in (data.positions, eye, orient))
        sc = data._replace(positions=p)
        if silhouette:
            img = render_grad.render_rgb_silhouette(sc, accel, e, o, config,
                                                    size, size,
                                                    edge_table=(ev, ef))
        else:
            img = render_grad.render_rgb_vjp(sc, accel, rays, e, o, config,
                                             frame_hw=hw)
        (img * w).sum().backward()
        return img.detach(), p.grad, e.grad, o.grad

    # 42. The forward's bits, the launches, the probes' sweep against plain.
    with torch.no_grad():
        ref = render_grad.render_rgb(data, accel, rays, eye, orient, config,
                                     frame_hw=hw)
    step()  # warm-up
    sync_device(dev)
    rec = Recorder(bounce_sweep, ["_closest_rays_cuda"])
    try:
        sweep.reset_launch_counts()
        scatter.reset_launch_counts()
        img, gp, ge, go = step()
        sync_device(dev)
        launches = {**sweep.launch_counts, **scatter.launch_counts}
    finally:
        rec.restore()
    print(f"silhouette step launches: {launches}")
    check(bits_equal(img, ref), "render_rgb_silhouette's image is not "
          "render_rgb's bit for bit")
    # G runs once: the row gather's backward (the textures take no grad).
    check(launches["primary"] > 0 and launches["closest_rays"] > 0
          and launches["scatter_add"] >= 1,
          f"silhouette step: launches {launches}")
    s = edge_grad.edge_samples(data.positions, data.faces, ev, ef, eye,
                               orient, size, size, 1.0,
                               config.diff.edge_samples)
    live = int(s.live.sum())
    print(f"config 4 at {size}x{size}: {ev.shape[0]} edges (table {table_s:.2f}"
          f" s on the host), {int(s.silhouette.sum())} silhouette edges, "
          f"{live} live samples of {s.live.numel()} "
          f"(K = {config.diff.edge_samples}), {2 * live} probe rays traced")
    d_pos, d_eye, d_orient = edge_grad.boundary_vjp(
        w, data, accel, ev, ef, eye, orient, config, size, size,
        num_samples=config.diff.edge_samples,
        offset_px=config.diff.edge_offset_px)
    flags = {name: (bool(torch.isfinite(x).all()), bool((x != 0).any()))
             for name, x in (("positions", d_pos), ("eye", d_eye),
                             ("orient", d_orient))}
    print(f"boundary term (finite, nonzero): {flags}; max |d_pos| "
          f"{float(d_pos.abs().max()):.6g}, d_eye {d_eye.tolist()}")
    check(all(f and z for f, z in flags.values()),
          f"boundary term not finite and nonzero: {flags}")
    check(all(bool(torch.isfinite(x).all()) for x in (gp, ge, go)),
          "silhouette step gradients not finite")
    args = rec.calls["_closest_rays_cuda"][-1]
    k = sweep._closest_rays_cuda(*args)
    p = sweep._closest_rays_plain(*args)
    sync_device(dev)
    hits, _ = closest_err(k, p, "C's epilogue over F's sweep (probes)")
    probes = int(args[3].sum())
    check(probes == 2 * live, f"probe sweep: {probes} active rays, "
          f"{2 * live} probes")
    print(f"probe sweep (C's epilogue over F's sweep) matches plain bit for "
          f"bit: {probes} probe rays in {args[3].shape[0]} groups, {hits} "
          f"hit")
    # The probes in screen order against the edges' order: the same bits,
    # and each order's clusters listed a group and probes' sweep time.
    screen_order = edge_grad._screen_order
    orders = {"screen": screen_order,
              "edge": lambda rows, pix, width, height: rows}
    terms, listed, order_ms = {}, {}, {}
    for name, order in orders.items():
        edge_grad._screen_order = order
        rec = Recorder(bounce_sweep, ["_closest_rays_cuda"])
        try:
            profiler.collect()
            with profiler.tracing():
                terms[name] = edge_grad.boundary_vjp(
                    w, data, accel, ev, ef, eye, orient, config, size, size,
                    num_samples=config.diff.edge_samples,
                    offset_px=config.diff.edge_offset_px)
            counters = profiler.collect().counters
        finally:
            rec.restore()
            edge_grad._screen_order = screen_order
        order_args = rec.calls["_closest_rays_cuda"][-1]
        listed[name] = counters["general_pairs"] / order_args[3].shape[0]
        order_ms[name] = time_cuda(
            lambda: sweep._closest_rays_cuda(*order_args), 20)
    check(all(bits_equal(a, b) for a, b in zip(terms["screen"],
                                               terms["edge"])),
          "boundary_vjp's terms differ between the screen and edge orders")
    print(f"probes in screen order: the terms bit-equal to the edges' "
          f"order; clusters listed a group {listed['screen']:.2f} (edge "
          f"order {listed['edge']:.2f}) of {accel.cmin.shape[0]}; the "
          f"probes' sweep {order_ms['screen']:.4f} ms (edge order "
          f"{order_ms['edge']:.4f} ms; events, 20 launches)")

    fwd_ms = time_cuda(lambda: render_grad.render_rgb_silhouette(
        data, accel, eye, orient, config, size, size, edge_table=(ev, ef)), 5)
    step_ms = time_cuda(step, 3)
    vjp_ms = time_cuda(lambda: step(False), 3)
    term_ms = time_cuda(lambda: edge_grad.boundary_vjp(
        w, data, accel, ev, ef, eye, orient, config, size, size), 3)
    print(f"on {card}: render_rgb_silhouette forward {fwd_ms:.4f} ms, "
          f"forward+backward {step_ms:.4f} ms; render_rgb_vjp "
          f"forward+backward {vjp_ms:.4f} ms; boundary_vjp alone "
          f"{term_ms:.4f} ms (events; config 4, {size}x{size})")
    clock.done("42 (silhouette term)")

    # 43. Finite differences of the flat triangle on BRUTE (kernel E).
    tri = interop.scene_from_numpy(
        positions=np.array([[-2.0, -2.0, 3.0], [2.0, -2.0, 3.4],
                            [0.0, 2.5, 3.2]], np.float32),
        faces=np.array([[0, 1, 2, 0]], np.int32),
        attrs={1: np.array([[0.0, 0.0, -1.0]] * 3, np.float32)},
        mesh_material=np.zeros(1, np.int32),
        albedo=np.array([[0.8, 0.6, 0.4]], np.float32),
        texture_id=np.array([-1], np.int32),
        textures=np.zeros((1, 1, 1, 3), np.float32), device=dev)
    brute = RenderConfig(accel=AccelKind.BRUTE, diff=DiffConfig(
        silhouette=True, edge_samples=SIL_FD_SAMPLES, edge_offset_px=0.02))
    e0, o0 = torch.zeros(3, device=dev), torch.eye(3, device=dev)
    fw = torch.from_numpy(np.random.default_rng(0).uniform(
        0.2, 1.0, (81, 3)).astype(np.float32)).to(dev)
    fine = camera_ray_grid(9 * fd_ss, 9 * fd_ss, device=dev)
    bruteforce.reset_launch_counts()
    for axis in (0, 1):
        shift = torch.zeros(3, device=dev)
        shift[axis] = 1.0

        def grad(dx):
            d = torch.tensor(dx, device=dev, requires_grad=True)
            out = render_grad.render_rgb_silhouette(
                tri._replace(positions=tri.positions + shift * d), None, e0,
                o0, brute, 9, 9)
            (out * fw).sum().backward()
            return float(d.grad)

        def box(dx):
            with torch.no_grad():
                out = render_grad.render_rgb(
                    tri._replace(positions=tri.positions + shift * dx), None,
                    fine, e0, o0, brute)
            return out.reshape(9, fd_ss, 9, fd_ss, 3).mean(dim=(1, 3)) \
                .reshape(81, 3)

        eps = 0.1
        a0 = grad(0.0)
        simpson = (grad(-eps) + 4.0 * a0 + grad(eps)) / 6.0
        fd = float(((box(eps) - box(-eps)) * fw).sum()) / (2 * eps)
        print(f"flat triangle, axis {axis}: boundary gradient {a0:.6g}, "
              f"Simpson {simpson:.6g}, finite difference of the {fd_ss}x "
              f"box-filtered image {fd:.6g}")
        check(abs(fd) > 0.05 and a0 != 0.0, "finite-difference fixture weak")
        check(abs(simpson - fd) <= 0.12 * abs(fd),
              f"axis {axis}: Simpson {simpson} vs finite difference {fd}")
    e_launches = bruteforce.launch_counts["brute"]
    check(e_launches > 0, "kernel E never launched in the FD check")
    clock.done("43 (silhouette finite differences)")
    return {"primary": launches["primary"],
            "scatter_add": launches["scatter_add"], "brute": e_launches}


def dist_path(dev, clock, card, c4, bench, size=C4_SIZE,
              c5_meshes=C5_MESHES, c5_hw=(C5_HEIGHT, C5_WIDTH),
              c4_faces=(C4_ARMADILLO, C4_F16)):
    """Phases 44-47: the distributed layer at world size 1 over NCCL, each
    sharded call against its unsharded call (bit-equal) and timed beside
    it: config 4's render, progressive and Adam steps, config 5's bounces,
    the primitive ring on the bench frame's rays; then two ranks on the
    one card over gloo (``c4`` is `config4_scene` of ``c4_faces``, which
    the ranks build again).  Returns ``{record name: launches}``."""
    import socket

    import torch
    import torch.distributed as dist

    from raytracercuda_torch.diff import render_grad, scatter
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.parallel import mesh as pmesh
    from raytracercuda_torch.parallel import ring, shard
    from raytracercuda_torch.trace import bounce_sweep, sweep
    from raytracercuda_torch.trace.bounce import render_bounces
    from raytracercuda_torch.trace.pipeline import rotate_rays
    from raytracercuda_torch.trace.progressive import (init_progressive,
                                                       progressive_step)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    check(pmesh.initialize_distributed(
        init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
        backend="nccl"), "initialize_distributed returned False")
    counts = {}

    def counted(fn):
        sweep.reset_launch_counts()
        scatter.reset_launch_counts()
        out = fn()
        sync_device(dev)
        for key, v in {**sweep.launch_counts,
                       **scatter.launch_counts}.items():
            counts[key] = counts.get(key, 0) + v
        return out

    try:
        mesh = pmesh.make_ray_mesh(1)
        backend = dist.get_backend()
        print(f"process group: backend {backend}, world "
              f"{dist.get_world_size()}, mesh {mesh}")
        config, data, accel, eye, orient = c4
        n, hw = size * size, (size, size)
        rays = camera_ray_grid(size, size, device=dev)
        zero = torch.zeros((n, 3), device=dev)

        # 44. Config 4: render, progressive step, Adam step.
        with torch.no_grad():
            got = counted(lambda: shard.render_sharded(
                data, accel, rays, eye, orient, config, mesh, frame_hw=hw))
            frame_ref = render_grad.render_rgb(data, accel, rays, eye,
                                               orient, config, frame_hw=hw)
        check(bits_equal(got, frame_ref),
              "render_sharded differs from render_rgb")

        def prog_sharded(st):
            return shard.progressive_step_sharded(
                st, data, accel, eye, orient, size, size, config, mesh,
                with_shadows=True)

        def prog(st):
            return progressive_step(st, data, accel, eye, orient, size, size,
                                    config, with_shadows=True)

        with torch.no_grad():
            a = b = init_progressive(n, device=dev)
            for _ in range(2):
                a = counted(lambda: prog_sharded(a))
                b = prog(b)
            check(bits_equal(a.accum, b.accum) and a.count == b.count == 2,
                  "progressive_step_sharded differs from progressive_step")
            st = init_progressive(n, device=dev)
            ms = {"progressive": (time_cuda(lambda: prog_sharded(st), 5),
                                  time_cuda(lambda: prog(st), 5))}

        params = {"positions": data.positions, "textures": data.textures}
        train, opt = shard.make_train_step(config, mesh, frame_hw=hw)
        state0 = opt.init(params)

        def single():
            """One process: `torch.optim.Adam` (lr 1e-2) on `render_rgb`'s
            gradient of the same loss."""
            leaves = [x.detach().clone().requires_grad_()
                      for x in params.values()]
            adam = torch.optim.Adam(leaves, lr=1e-2)
            out = render_grad.render_rgb(
                data._replace(positions=leaves[0], textures=leaves[1]),
                accel, rays, eye, orient, config, frame_hw=hw)
            loss = torch.sum((out - zero) ** 2) / (n * 3)
            loss.backward()
            adam.step()
            return [x.detach() for x in leaves], loss.detach()

        def sharded():
            return train(params, state0, data, accel, rays, eye, orient, zero)

        # G's sorted route makes both backward passes bitwise repeatable.
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            new, _, loss = counted(sharded)
            ref, ref_loss = single()
            sync_device(dev)
        finally:
            torch.use_deterministic_algorithms(was)
        for (name, x), y in zip(new.items(), ref):
            check(bits_equal(x, y), f"train step: {name} after one Adam step "
                  f"differs from one process's ({int((x != y).sum())} "
                  f"entries)")
        check(bits_equal(loss, ref_loss), f"train step loss {float(loss)} "
              f"vs {float(ref_loss)}")
        check(not torch.equal(new["positions"], data.positions),
              "train step moved no vertex")
        ms["train step"] = (time_cuda(sharded, 5), time_cuda(single, 5))
        print(f"config 4 at {size}x{size}: render_sharded, "
              f"progressive_step_sharded (2 steps, shadows) and the Adam "
              f"step of make_train_step (positions, textures; loss "
              f"{float(loss):.6g}) bit-equal to the unsharded calls")
        clock.done("44 (sharded config 4)")

        # 45. Config 5's bounces.
        c5_config, c5_data, c5_accel, c5_eye = config5_scene(dev, c5_meshes)
        height, width = c5_hw
        dirs = rotate_rays(camera_ray_grid(width, height, device=dev),
                           torch.eye(3, device=dev))

        def bounces_sharded():
            return shard.render_bounces_sharded(
                c5_accel, c5_data, c5_eye, dirs, height, width, c5_config,
                mesh)

        def bounces():
            return render_bounces(c5_accel, c5_data, c5_eye, dirs, height,
                                  width, c5_config)

        got = counted(bounces_sharded)
        bounce_ref = bounces()
        check(bits_equal(got, bounce_ref),
              "render_bounces_sharded differs from render_bounces")
        ms["bounces"] = (time_cuda(bounces_sharded, 3), time_cuda(bounces, 3))
        print(f"config 5 at {width}x{height}: render_bounces_sharded "
              f"bit-equal to render_bounces")
        clock.done("45 (sharded config 5)")

        # 46. The primitive ring on the bench frame's primary rays.
        b_data, b_accel, b_eye, b_orient, b_rays = bench
        b_dirs = rotate_rays(b_rays, b_orient)
        origin = b_eye[None, :].expand(b_dirs.shape)
        padded = ring.pad_clusters_for_ring(b_accel, mesh.size())

        def ring_trace():
            return ring.trace_ring_sharded(padded, origin, b_dirs, mesh)

        def replicated():
            return bounce_sweep.trace_rays(b_accel, sweep.segment_blocks(
                b_accel), origin, b_dirs)

        got = counted(ring_trace)
        want = replicated()
        check(torch.equal(got.face, want.face) and all(
            bits_equal(getattr(got, f), getattr(want, f)) for f in "tuv"),
            "trace_ring_sharded differs from trace_rays")
        check(bool((want.face >= 0).any()), "ring: no ray hit")
        ms["ring"] = (time_cuda(ring_trace, 5), time_cuda(replicated, 5))
        print(f"bench frame's {b_dirs.shape[0]} primary rays: "
              f"trace_ring_sharded bit-equal to trace_rays "
              f"({int((want.face >= 0).sum())} hits)")
        for name, (sharded_ms, plain_ms) in ms.items():
            print(f"on {card}, world size 1 over {backend}: {name} sharded "
                  f"{sharded_ms:.4f} ms, unsharded {plain_ms:.4f} ms "
                  f"(events), the layer's overhead "
                  f"{sharded_ms - plain_ms:+.4f} ms")
        print(f"distributed launches (the checked runs): {counts}")
        check(counts["primary"] > 0 and counts["occlusion_rows"] > 0
              and counts["scatter_sorted"] > 0 and counts["general_shade"] > 0
              and counts["closest_rays"] > 0,
              f"distributed layer: launches {counts}")
        clock.done("46 (ring, timing)")

        # 47. Two ranks on the one card over gloo (all-reduce and
        # all-gather carry CUDA tensors; send and receive do not, so the
        # ring's two ranks run in the CPU tests only).
        two = two_rank_run(dev.type, size, c4_faces, c5_meshes, c5_hw)
        for r, got in enumerate(two):
            for name, want in (("frame", frame_ref), ("progressive", b.accum),
                               ("bounces", bounce_ref)):
                check(bits_equal(got[name], want.cpu()), f"two ranks, rank "
                      f"{r}: {name} differs from the unsharded call")
        for name, x in two[0]["params"].items():
            check(bits_equal(x, two[1]["params"][name]),
                  f"two ranks: the ranks' {name} differ after the step")
        errs = {}
        for (name, x), y in zip(two[0]["params"].items(), ref):
            y = y.cpu()
            errs[name] = float((x - y).abs().max())
            check(errs[name] <= 1e-6 * float(y.abs().max()),
                  f"two ranks: {name} after one Adam step {errs[name]} from "
                  f"one process's")
        loss2, loss1 = float(two[0]["loss"]), float(ref_loss)
        check(abs(loss2 - loss1) <= 1e-6 * abs(loss1),
              f"two ranks: loss {loss2} vs {loss1}")
        print(f"two ranks on one card over gloo: render_sharded (config 4), "
              f"progressive_step_sharded (2 steps) and render_bounces_sharded "
              f"(config 5) bit-equal to the unsharded calls on both ranks; "
              f"the Adam step's params equal on both ranks, max abs diff "
              f"from one process's {errs}, loss {loss2:.9g} vs {loss1:.9g}")
        for name, ms_two in two[0]["ms"].items():
            print(f"on {card}, two ranks over gloo on the one card: {name} "
                  f"{ms_two:.4f} ms (events, rank 0; world size 1 over "
                  f"{backend}: {ms[name][0]:.4f} ms)")
        for got in two:
            for key, v in got["counts"].items():
                counts[key] = counts.get(key, 0) + v
        clock.done("47 (two ranks on one card)")
    finally:
        dist.destroy_process_group()
    return {"primary": counts["primary"],
            "scatter_add": counts["scatter_add"] + counts["scatter_sorted"],
            "occlusion_rows": counts["occlusion_rows"],
            "primary_shade": counts["primary_shade"],
            "occlusion": counts["occlusion"],
            "general_shade": counts["general_shade"]}


TWO_RANK_TIMEOUT = 300  # seconds for phase 47's two processes


def two_rank_worker(rank, world, directory, device, size, c4_faces,
                    c5_meshes, c5_hw):
    """One rank of phase 47 on card 0 (``device`` "cuda") over gloo: config
    4's sharded render, two progressive steps and one Adam step, and config
    5's bounces; saves them (on the CPU), their event times and the launch
    counts."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from raytracercuda_torch.diff import scatter
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.ops import cuda_build
    from raytracercuda_torch.parallel import mesh as pmesh
    from raytracercuda_torch.parallel import shard
    from raytracercuda_torch.trace import sweep
    from raytracercuda_torch.trace.pipeline import rotate_rays
    from raytracercuda_torch.trace.progressive import init_progressive

    dev = torch.device(device, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        cuda_build.load_library()
    check(pmesh.initialize_distributed(
        init_method="file://" + os.path.join(directory, "store"),
        world_size=world, rank=rank, backend="gloo"),
        "initialize_distributed returned False")
    try:
        mesh = pmesh.make_ray_mesh(world)
        config, data, accel, eye, orient = config4_scene(dev, *c4_faces)
        n, hw = size * size, (size, size)
        rays = camera_ray_grid(size, size, device=dev)
        zero = torch.zeros((n, 3), device=dev)
        params = {"positions": data.positions, "textures": data.textures}
        train, opt = shard.make_train_step(config, mesh, frame_hw=hw)
        state0 = opt.init(params)
        c5_config, c5_data, c5_accel, c5_eye = config5_scene(dev, c5_meshes)
        height, width = c5_hw
        dirs = rotate_rays(camera_ray_grid(width, height, device=dev),
                           torch.eye(3, device=dev))
        calls = {
            "render": lambda: shard.render_sharded(
                data, accel, rays, eye, orient, config, mesh, frame_hw=hw),
            "progressive": lambda st: shard.progressive_step_sharded(
                st, data, accel, eye, orient, size, size, config, mesh,
                with_shadows=True),
            "train step": lambda: train(params, state0, data, accel, rays,
                                        eye, orient, zero),
            "bounces": lambda: shard.render_bounces_sharded(
                c5_accel, c5_data, c5_eye, dirs, height, width, c5_config,
                mesh),
        }
        sweep.reset_launch_counts()
        scatter.reset_launch_counts()
        with torch.no_grad():
            frame = calls["render"]()
            st = init_progressive(n, device=dev)
            for _ in range(2):
                st = calls["progressive"](st)
            bounces = calls["bounces"]()
        new, _, loss = calls["train step"]()
        sync_device(dev)
        counts = {**sweep.launch_counts, **scatter.launch_counts}
        ms = {}
        if dev.type == "cuda":  # (a rehearsal on the CPU times nothing)
            st0 = init_progressive(n, device=dev)
            with torch.no_grad():
                ms["progressive"] = time_cuda(
                    lambda: calls["progressive"](st0), 3)
                ms["bounces"] = time_cuda(calls["bounces"], 3)
            ms["train step"] = time_cuda(calls["train step"], 3)
        torch.save({"frame": frame.cpu(), "progressive": st.accum.cpu(),
                    "bounces": bounces.cpu(), "loss": loss.cpu(),
                    "params": {k: v.cpu() for k, v in new.items()},
                    "counts": counts, "ms": ms},
                   os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def two_rank_run(device, size, c4_faces, c5_meshes, c5_hw) -> list:
    """Phase 47's two ranks (`two_rank_worker`) as spawned processes on the
    one card; each rank's results, in rank order.  Fails if a rank fails
    or the two outlast `TWO_RANK_TIMEOUT`."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as directory:
        ctx = mp.start_processes(
            two_rank_worker,
            args=(2, directory, device, size, c4_faces, c5_meshes, c5_hw),
            nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + TWO_RANK_TIMEOUT
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    fail(f"phase 47's two ranks took over {TWO_RANK_TIMEOUT} "
                         "s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return [torch.load(os.path.join(directory, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]




def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="an unpacked parent commit: time its kernels "
                        "I and J (phase 24) and M (phase 41) in turns with "
                        "this tree's")
    args = parser.parse_args()
    clock = PhaseClock()
    # 1. Device.
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "raytracercuda_torch")):
        fail("raytracercuda_torch/ not found beside chip_smoke.py: run it "
             "from a checkout of the repository")
    sys.path.insert(0, REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    import numpy as np

    from raytracercuda_torch.config import AccelKind, RenderConfig
    from raytracercuda_torch.models.camera import camera_ray_grid
    from raytracercuda_torch.models.procedural import bumpy_sphere_mesh
    from raytracercuda_torch.models.scene import Material, Scene
    from raytracercuda_torch.ops import cuda_build
    from raytracercuda_torch.trace import sweep
    from raytracercuda_torch.trace.frame import FrameRenderer

    clock.done("1 (device)")

    # 2. Build, with each kernel's registers from ptxas.
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        path, secs = cuda_build.build(verbose=True)
    print(log.getvalue(), end="")
    print(f"build: {secs:.2f} s -> {os.path.relpath(path, REPO)}")
    print("registers per thread: "
          f"{kernel_registers(log.getvalue()) or 'not printed (built before)'}")
    print("kernel M's shared memory a block (bytes): "
          + str({k: v for k, v in kernel_shared(log.getvalue()).items()
                 if k.startswith("march_kernel")}))
    cuda_build.load_library()

    # The bench frame's scene and camera (bench.py's framing).
    config = RenderConfig(accel=AccelKind.CLUSTER)
    scene = Scene(config, device=dev)
    scene.add_mesh(bumpy_sphere_mesh(NUM_FACES))
    scene.materials = [Material(albedo=(0.9, 0.7, 0.5), texture_id=0)]
    scene.textures = [np.random.default_rng(0).random((64, 64, 3))]
    data = scene.data()
    lo = data.positions.amin(dim=0)
    hi = data.positions.amax(dim=0)
    extent = float((hi - lo).amax())
    eye = ((lo + hi) / 2 - torch.tensor([0.0, 0.0, 2.0 * extent],
                                        device=dev)).to(torch.float32)
    orient = torch.eye(3, device=dev)
    rays = camera_ray_grid(SIZE, SIZE, device=dev)
    renderer = FrameRenderer(data, scene.accel, config, SIZE, SIZE)
    torch.cuda.synchronize()

    clock.done("2 (build)")

    # 3. The main path, once, through both kernels; record their inputs.
    rec = Recorder(sweep, ["_primary_shade_cuda", "_occlusion_cuda"])
    try:
        sweep.reset_launch_counts()
        frame = renderer.render(eye, orient, rays)
        torch.cuda.synchronize()
        launches = dict(sweep.launch_counts)
    finally:
        rec.restore()
    print(f"main path launches: {launches}")
    check(launches["primary_shade"] > 0, "kernel A never launched")
    check(launches["occlusion"] > 0, "kernel B never launched")
    staged_counts(launches, "bench frame")
    check(tuple(frame.shape) == (SIZE * SIZE,), f"frame shape {frame.shape}")
    frame_bits(frame, "bench frame")
    a_args = rec.calls["_primary_shade_cuda"][-1]
    b_args = rec.calls["_occlusion_cuda"][-1]
    lists = a_args[0]
    print(f"tiles {lists.counts.numel()}, clusters {data.num_faces} faces "
          f"-> {scene.accel.num_clusters}, listed per tile: max "
          f"{int(lists.counts.max())}, mean {float(lists.counts.float().mean()):.2f}")

    clock.done("3 (bench frame)")

    # 4. Kernels against their plain versions on the frame's inputs.
    ka = staged_rows_check(sweep, "eye", sweep._primary_shade_cuda, a_args,
                           "kernel A (bench frame)")
    pa = sweep._primary_shade_plain(*a_args)
    torch.cuda.synchronize()
    a_err, hits, _ = shade_err(ka, pa, "kernel A")
    kb = staged_rows_check(sweep, "light", sweep._occlusion_cuda, b_args,
                           "kernel B (bench frame)")
    pb = sweep._occlusion_plain(*b_args)
    torch.cuda.synchronize()
    b_err = occlusion_err(kb, pb, "kernel B")
    shadowed = int(pb.sum())
    a_items, _ = split_stats(lists, sweep.SHADE_CHUNK, a_args[2].shape[2])
    b_items, b_lanes = split_stats(b_args[0], sweep.OCCLUSION_CHUNK,
                                   b_args[2].shape[2], b_args[3])
    print(f"kernel A matches plain: {hits} hit rays, t/u/v bit-equal, "
          f"attributes max abs err {a_err:.3g}; {a_items} work items at K = "
          f"{sweep.SHADE_CHUNK}")
    print(f"kernel B matches plain: {shadowed} shadowed of "
          f"{int(b_args[3].sum())} active shadow rays in "
          f"{int(b_args[3].any(dim=1).sum())} tiles; {b_items} work items at "
          f"K = {sweep.OCCLUSION_CHUNK}, {b_lanes:.2f} active lanes per warp")
    check(hits > 0, "no primary ray hit the scene")
    check(shadowed > 0, "no pixel is in shadow")

    clock.done("4 (A, B vs plain)")

    # 5. The frame with the plain versions on the card.
    with PlainOnCard({sweep: {
            "_primary_shade_cuda": sweep._primary_shade_plain,
            "_occlusion_cuda": sweep._occlusion_plain}}):
        plain_frame = renderer.render(eye, orient, rays)
        torch.cuda.synchronize()
        plain_ms = time_cuda(lambda: renderer.render(eye, orient, rays),
                             FRAMES)
    worst = u8_diff(frame, plain_frame)
    check(worst <= 1, f"kernel frame vs plain frame: u8 diff {worst}")
    background = (0 << 16) | (255 << 8) | 0
    n_hit_px = int((frame != background).sum())
    print(f"frame matches plain frame (max u8 diff {worst}); "
          f"{n_hit_px} of {SIZE * SIZE} pixels not background")
    check(n_hit_px > 0, "frame is all background")

    clock.done("5 (plain frame)")

    # 6. Timing.
    def render():
        return renderer.render(eye, orient, rays)

    def kernel_a():
        return sweep._primary_shade_cuda(*a_args)

    def kernel_b():
        return sweep._occlusion_cuda(*b_args)

    frame_ms = time_cuda(render, FRAMES)
    a_ms = time_cuda(kernel_a, 20)
    a_plain_ms = time_cuda(lambda: sweep._primary_shade_plain(*a_args), 5)
    b_ms = time_cuda(kernel_b, 20)
    b_plain_ms = time_cuda(lambda: sweep._occlusion_plain(*b_args), 5)
    px = SIZE * SIZE
    cast = px + int(b_args[3].sum())  # primary rays + cast shadow rays
    for name, ms in (("kernel", frame_ms), ("plain", plain_ms)):
        print(f"frame ({name} path): {ms:.4f} ms/frame, "
              f"{px / ms * 1e3:.6g} rays/s as bench.py counts them (W*H "
              f"per frame), {cast / ms * 1e3:.6g} primary+shadow rays/s "
              f"cast")
    print(f"kernel A: {a_ms:.4f} ms (plain {a_plain_ms:.4f} ms); "
          f"kernel B: {b_ms:.4f} ms (plain {b_plain_ms:.4f} ms)")

    clock.done("6 (frame timing)")

    shade_kernels = shade_path(dev, clock, renderer, eye, orient, rays)
    c4 = config4_scene(dev, C4_ARMADILLO, C4_F16)
    c5 = config5_scene(dev, C5_MESHES)
    cull_kernels = cull_path(dev, clock, renderer, eye, orient, rays, c4, c5)
    c4_kernels = diff_path(dev, clock, card, c4=c4)
    # Phases 42-46: the silhouette term and the distributed layer.
    slice_launches = [silhouette_path(dev, clock, card, c4),
                      dist_path(dev, clock, card, c4,
                                (data, scene.accel, eye, orient, rays))]
    del c4
    c2 = api_path(dev, clock, card)
    c5_kernels, c5_ab = bounce_path(dev, clock, card, c5=c5)
    del c5
    c1_kernels, c1_clear = fill_path(dev, clock, card,
                                     parent=args.parent)
    app = app_path(dev, clock, card)
    bvh_kernels, bvh_frame_ms = bvh_path(dev, clock, card, data, eye, orient,
                                         rays)
    for k in bvh_kernels:  # the CLI's and fly's launches of K and L
        k["launches"] += app[k["name"]]
    grid_kernel, grid_frame_ms = grid_path(dev, clock, card, data, eye,
                                           orient, rays, parent=args.parent)
    print(f"frames at {SIZE}x{SIZE} on {card}: BVH route (L, shadows by E) "
          f"{bvh_frame_ms:.4f} ms, {px / bvh_frame_ms * 1e3:.6g} rays/s; "
          f"GRID route (M, shadows by E) {grid_frame_ms:.4f} ms, "
          f"{px / grid_frame_ms * 1e3:.6g} rays/s; "
          f"CLUSTER bench frame (A, B) {frame_ms:.4f} ms, "
          f"{px / frame_ms * 1e3:.6g} rays/s (W*H per frame)")

    # 29. The bench frame's device times, and A's and B's with their K
    # sweeps: last, so that no profiler session runs before the config-4
    # steps that phase 13 times by events.
    frame_device_ms = device_ms(render, 10)[0]
    print(f"bench frame (kernel path) on the card: "
          f"{ms_text(frame_device_ms)} (every activity summed)")
    a_device_ms, b_device_ms = split_chunk_report(
        sweep, "bench frame", kernel_a, kernel_b, a_args, b_args, 20)
    clock.done("29 (bench frame device times)")

    # Bounds of A and B on the bench frame's inputs, where their times are
    # taken (config 5's are printed above).
    a_tests = sweep_tests(lists, a_args[2].shape[2], a_args[3].shape[1])
    b_tests = sweep_tests(b_args[0], b_args[2].shape[2], b_args[4].shape[1],
                          active=b_args[3], occluded=pb)
    print(f"bench frame: kernel A {a_tests} ray-triangle tests, kernel B "
          f"{b_tests}")
    # Launches: every path that runs a kernel; A's and B's error the larger
    # of the bench frame's and config 5's.
    src = "raytracercuda_torch/csrc/sweep.cu"
    kernels = [
        kernel_record("primary_shade", src,
                      "raytracercuda_tpu/trace/pallas_sweep.py:598",
                      launches["primary_shade"] + c5_ab["primary_shade"][0]
                      + app["primary_shade"],
                      max(a_err, c5_ab["primary_shade"][1]), a_ms, a_plain_ms,
                      bound(a_tests * MT_OPS, nbytes(a_args, ka)),
                      device_ms=a_device_ms),
        kernel_record("occlusion", src,
                      "raytracercuda_tpu/trace/pallas_sweep.py:870",
                      launches["occlusion"] + c5_ab["occlusion"][0]
                      + app["occlusion"], max(b_err, c5_ab["occlusion"][1]),
                      b_ms, b_plain_ms,
                      bound(b_tests * MT_OPS, nbytes(b_args, kb)),
                      device_ms=b_device_ms),
        *c4_kernels,
        kernel_record("clear", "raytracercuda_torch/csrc/frame.cu",
                      "raytracercuda_tpu/ops/clear.py:21",
                      **{**c2["clear"],
                         "launches": c2["clear"]["launches"] + c1_clear}),
        kernel_record("brute", "raytracercuda_torch/csrc/brute.cu",
                      "raytracercuda_tpu/trace/pallas_brute.py:36",
                      **{**c2["brute"],
                         "launches": c2["brute"]["launches"] + app["brute"]}),
        *c5_kernels, *c1_kernels, *bvh_kernels, grid_kernel,
        *cull_kernels, *shade_kernels,
    ]
    by_name = {k["name"]: k for k in kernels}
    by_name["primary"]["launches"] += app["primary"]  # the CLI's parity route
    for extra in slice_launches:  # phases 42-46
        for name, count in extra.items():
            by_name[name]["launches"] += count
    print(f"kernels against their bounds on {card}:")
    for k in kernels:
        library = k["library_ms"]
        device = ("" if k["device_ms"] is None else
                  f" (device {k['device_ms']:.4f} ms)")
        zeroed = ("" if k["library_zeroed_ms"] is None else
                  f", zeros + library {k['library_zeroed_ms']:.4f} ms")
        print(f"  {k['name']}: {k['ms']:.4f} ms{device}, bound "
              f"{k['bound_ms']:.6f} ms by {k['bound_by']} "
              f"({k['bound_ms'] / k['ms']:.2%} of it reached), plain "
              f"{k['plain_ms']:.4f} ms, library "
              f"{'none' if library is None else f'{library:.4f} ms'}"
              f"{zeroed}, {k['launches']} launches")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
