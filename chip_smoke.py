#!/usr/bin/env python3
"""On-card proof of the PyTorch port (``pbrt_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout; it builds every kernel it needs from the sources in
``pbrt_torch/csrc`` (nvcc for sm_90a, g++ for the SAH builder) and imports
nothing of JAX or of the JAX package. Phases, each on its own line:

1. device — the card, and nvidia-smi's name and power limit;
2. build — one library per kernel source (and the FMA-contracted copy of
   the traversal's), one nvcc each, all started together with the SAH
   builder's g++; ptxas' register / spill report; the keyed kernels' SASS
   counted by opcode (cuobjdump), per inlined threefry hash;
3. kernels vs plain — on ≥ 1M lanes of the real-size scene (camera rays
   and cosine-sampled bounce rays from their first hits): the standalone
   step, closest-hit and any-hit traversal against their plain PyTorch
   versions, closest hit on 4,096 lanes against ``intersect_brute``, and
   all three on ragged lane counts (1, 7, 4,093); then the traversal
   timed on two 32,768-lane sets, a random permutation of the mixed rays
   and a render-order set (camera rays of consecutive pixels from the
   frame's middle, then their first bounces in the same order), each with
   the plain version's steps per lane and per warp. Every kernel time in
   the script is CUDA events around back-to-back wrapper calls enqueued
   behind a spin kernel (``timing.queued_ms``), so the device never waits
   on the host;
4. rng — the keyed-uniform kernel (the wave's whole primary-sample array,
   camera columns and bounce block, depth 5), the AO kernel (ambient
   occlusion's array, 1, 4 and 64 AO samples) and the scramble kernel
   against their plain versions on 1,048,576 lanes, bit for bit, for
   samples 0, 3 and 2**31 + 1; then on ragged lane counts (1 to 32,767),
   depths 0, 1, 4 and 5, 1, 4 and 64 AO samples and pixel indices at and
   above 2**31; each timed in 5 rounds (median, min–max) at the main
   path's launch widths (the AO kernel with 4 AO samples);
5. small reference — every integrator kind on the tiny scene, and
   ``path`` and ``directlighting`` on the lights-and-quadrics scene at 16²
   (with a 2,880-triangle blob), rendered on the card and on the CPU
   (plain versions) from the same primary-sample array, and by
   ``render(seed=...)`` on both (keyed by threefry), the tiny scene's
   ``path`` render on the card at two chunk widths;
6. gather lab — its kernel against its plain version at the lab's shapes,
   bit for bit, then on 1 to 32,768 lanes of 7-, 64- and 16,384-row tables
   with start indices outside the table at lanes 0, 31 and the last; then
   the lab's own path (``gather_lab.main()``: the kernel's time in 5 rounds,
   the bound and the L2 read ceiling) with its launch counters set to 0
   just before and read just after;
7. render — the main path: ``goldens/killeroo-simple.pbrt`` as written
   (``directlighting``, its default depth 5) through ``load_scene_string``
   → ``build`` → ``render`` at 512², 32 bins, 32,768-lane chunks,
   lowdiscrepancy, box filter; one warm-up sample, then 4 timed samples
   (CUDA events), with the kernels' launch counters set to 0 just before
   and read just after, and the sampler's torch path (``camera_uniforms``,
   ``_bits_to_unit``) counted, which must not run on the card; the film is
   checked and a ``.dat`` written and read back; one chunk's wave of one
   more 1-spp frame under the profiler, scaled to the frame's 8 chunks,
   splits the device time by kernel, the traversal's
   into closest hit and any hit, with launches per chunk and host-to-device
   copies. Then the same for the ``path`` integrator at depth 5 (the
   earlier slices' main path);
8. kinds — the same 512² scene at 1 spp with ``whitted``,
   ``ambientocclusion`` (4 AO samples) and ``metadata`` (depth, mesh and
   material ids), each with its launches counted; the material ids equal
   to the CPU's on the same rays; then the lights-and-quadrics scene (the
   512² scene with a point, a spot and a distant light, an emissive
   two-triangle quad and a disk, cylinder, cone, paraboloid and
   hyperboloid) with ``path`` and ``directlighting``;
9. materials and environment — the 512² scene with generated blobs whose
   materials and lights this slice added (``MATERIALS_AND_ENV``: a
   substrate floor, an uber wall, blobs in glass and metal, spheres in
   shinymetal, anisoward, Oren–Nayar matte, translucent, a mix and both
   measured formats; a mapped infinite, a projection and a goniometric
   light beside the sphere light; maps, ``.brdf`` and MERL files
   generated from a fixed seed into a temporary directory): the
   closest-hit and any-hit kernels against their plain versions, bit for
   bit, on 1,048,576 of its first reflected and transmitted rays; then
   ``path`` and ``directlighting`` at depth 2 (``SCENE_DEPTH``, cut from
   5 to keep the script within half its limit), 1 spp, after a warm-up
   sample, each counted and profiled as in phase 7 (camera paths/s,
   launches per chunk, kernel time with the closest / any split,
   host-to-device copies, film and ``.dat`` checks); then its 16² version
   (2,880-triangle blobs) rendered on the card and on the CPU, from the
   same primary-sample array and by ``render(seed=...)``;
10. textures — ``goldens/metal.pbrt`` as written (its text read from the
   repository; the files it reads, not in the repository, generated from a
   fixed seed into a temporary directory by ``write_texture_data``: a
   300×200 line image, a 1024×512 lat-long sky, gold's η and k curves and a
   64,980-triangle stand-in teapot), built with no warning (every image
   loaded), at its 256², 16 spp, ``path``, after a warm-up sample, counted
   and profiled as in phase 7; the same scene at 1 spp with its three
   textures replaced by Kd .5 and no bump map, its launches per chunk and
   kernel time beside the textured frame's; the texture-kinds scene
   (``TEXTURE_KINDS``: the 512² scene with generated blobs, its floor in an
   imagemap under EWA at grazing angles, its wall in a 2D checkerboard, the
   blobs in a 3D checkerboard and marble, twelve spheres in dots, fbm,
   wrinkled, windy, bilerp, uv, mix and scale textures under the uv,
   spherical and planar mappings, a normal map, a bump map and a mix
   material with textured sub-materials) with ``path`` at depth 2
   (``SCENE_DEPTH``, cut from 5) and 1 spp, counted
   and profiled; then both at 16² (2,880-triangle teapot and blobs) on the
   card and on the CPU, from the same primary-sample arrays and by
   ``render(seed=...)``, each comparison pooled over 8 waves or seeds;
11. motion and instancing — ``goldens/anim-killeroos-moving.pbrt`` as
   written (its text read from the repository, each killeroo the generated
   blob; 256², 8 spp, ``directlighting``, both blobs moving), counted and
   profiled as in phase 7, then with its shutter pinned at 0 (the frames
   must differ: the smear); 64 static ``ObjectInstance``s of one blob on an
   8×8 grid (each turned and scaled) in the killeroo-simple scene at 512²,
   ``path`` depth 5, 1 spp, counted and profiled, with the geometry's
   device bytes against 64 flattened copies (computed); the motion kernels
   (each child culled by its box at the ray's time) on 1,048,576 of the
   motion scene's rays (camera rays at their own shutter times, bounce
   rays from their first hits), against the union plain walk (the JAX
   package's) and the culled one (their own, whose work gives the bound)
   on the 32,768-lane permuted set of them that times them, both walks'
   steps per lane logged (a plain walk lasts as long as its longest ray,
   whatever the lanes), against the union walk on 1, 7 and 4,093 lanes and
   on the tie-and-dense scene with motion under the BVH, and closest hit
   against ``intersect_brute`` on the lerped triangles; the instance kernels
   (each group of 8 lanes box-testing 8 instances at once and stepping
   through its own candidates in the serial order) on 1,048,576 rays of the
   instanced scene, likewise (the instance included), their registers and
   blocks per SM, and the plain phase's counts on the timed set (walks,
   BLAS steps and box tests per lane; per warp of 4 rays, the steps of one
   instance at a time for the warp against each ray's own), and on the
   instanced tie scene (``instance_tie_scene_text``: every use's walk ties);
   the 16² motion scene
   and an 8-use instanced scene card vs CPU (8 waves and 8 seeds pooled),
   the 8-use scene against its flattened copy; then the static kernels
   re-timed on phase 3's sets;
12. lens cameras and the spectral renderer — the 512² scene with its
   camera replaced (``LENS_CAMERAS``; the lens and eye files, written by
   ``write_lens_data`` into a temporary directory, are the D-Gauss F/2 of
   US patent 2,673,491 at 50 mm and a generated 4-surface schematic eye):
   (a) ``realisticDiffraction`` with diffraction and chromatic aberration
   under ``Renderer "spectral"`` with 32 bands (``singleDirection``),
   ``directlighting`` depth 5 as written, at 256², 1 spp, counted as in phase 7
   (camera paths: pixels × bands), one chunk's band-0 wave profiled and
   scaled to the frame; the closest-hit and any-hit kernels against their
   plain versions on the frame's 65,536 lens rays of band 0, dead lanes
   (direction 0) included, and the dead lanes' radiance (must be 0); the
   keyed-normals kernel against its plain version on 1,048,576 lanes at 3
   samples and on 1, 7 and 4,093 lanes, bit for bit, and timed in 5
   rounds at 32,768 lanes × 11 tags with its bound; (b) ``realisticEye``
   with ior1..ior4 spectra and a curved retina under the sampler renderer,
   1 spp; (c) ``idealDiffraction``, ``orthographic``, ``pinhole`` and
   ``environment`` at 1 spp, each with one chunk profiled, and the
   ``cameras`` renderer on 2 transforms at 64²; (d) each camera, and the
   spectral renderer at 4 bands, at 16² on the card and on the CPU, 8
   waves and 8 seeds pooled;
13. samplers and media — killeroo-simple at 512² (``directlighting``
   depth 5 as written, 32,768-lane chunks): (a) under the ``halton``,
   ``bestcandidate``, ``stratified`` and ``random`` samplers, one timed
   1-spp frame each after a warm-up, counted as in phase 7 (the threefry
   torch ops among them), one chunk's wave profiled and scaled to the
   frame; ``adaptive`` at 2 and 8 samples under ``contrast`` and
   ``shapeid`` at 256² (no warm-up render), with the pixels supersampled,
   the waves and camera paths/s;
   (b) in a water box around the whole scene (``WATER_VOLUME``: σa from a
   generated absorption curve, σs, g 0.6; the transmittance from the camera
   to the killeroos checked in [0.2, 0.6]) under ``single`` scattering, and
   (c) the same box as a homogeneous fog with Le under ``emission``, 1 spp
   each, counted and profiled; the sampler codes and the media block
   against their plain versions, bit for bit, on 1,048,576 lanes and on
   1, 7 and 4,093 (the media block also on 32,768 and on rows wider than a
   tile), at samples 0, 3 and 2**31 + 1, and timed in 5 rounds with their
   bounds (the media block with its issue-slot bound, registers and blocks
   per SM, ``keyed_tile_timed``); the tiny scene at 16² under each sampler and in a
   volume of each kind under both volume integrators, card vs CPU (waves
   and seeds pooled); every view's CPU-against-itself per-bin difference
   with each image sample one ulp over is logged beside it (phase 5 on);
14. accelerators, refined shapes and ``goldens/bunny.pbrt`` —
   killeroo-simple at 512² with ``Accelerator "kdtree"`` and then
   ``"grid"``, ``directlighting`` and ``path`` depth 5, 1 spp each, counted
   and profiled (one chunk's wave scaled to the frame) beside phase 7's
   BVH frames, with build seconds and table
   sizes; the kd-tree and grid kernels against their plain versions, bit
   for bit, on 262,144 of the frame's camera and bounce rays and on 1, 7
   and 4,093 lanes, closest hit against ``intersect_brute``; the motion
   scene of phase 11 (as written, 64,980-triangle blobs, 256²) under each
   accelerator: its 1-spp frame, and the motion kernels against their
   plain versions on 65,536 of its rays; each kernel timed on a
   32,768-lane permuted set in 5 rounds with its bound; ``Renderer
   "aggregatetest"`` under the BVH, the kd-tree and the grid (0 rays may
   disagree); ``goldens/bunny.pbrt`` as written (256², 8 spp; its
   ``geometry/bunny.pbrt`` a generated 320-face loopsubdiv control mesh,
   its ``brdfs/mystique.brdf`` phase 9's measured-file stand-in); a 512²
   ``path`` frame of the refined shapes (a 256 × 256 heightfield floor, a
   NURBS patch, the loop-subdivided stand-in), timed and counted, not
   profiled; the tiny scene under each
   accelerator, the bunny and each refined shape at 16², card vs CPU;
15. the preprocess integrators — ``goldens/ss-envmap.pbrt`` as written
   (128², 64 spp, ``dipolesubsurface``; its ``geometry/room-teapot.pbrt``,
   ``textures/grace_latlong.exr`` and ``textures/lines.exr`` generated by
   ``write_ss_envmap_data``: a matte corner and a 32,000-triangle closed
   teapot-sized blob in the golden's subsurface material, phase 10's
   sky and stripes), built with its preprocess (4,096 points and their
   irradiance, threefry's torch ops counted: none), counted as in phase 7
   and one chunk's wave profiled with the Mo gather's share;
   killeroo-simple at 256², 1 spp under ``irradiancecache``,
   ``photonmap`` and ``igi``, each built with its preprocess (photon and
   VPL counts), counted and one chunk profiled; ``Renderer
   "surfacepoints"`` on the ss-envmap stand-in (the file's points, their
   pairwise minimum distance against ``minsampledistance``); the Mo-gather
   kernels (the lane list and the gather) against their plain version on
   32,768 of ss-envmap's first hits (``mo_lane_sets``: the subsurface hits
   active, and a sparse set of 5% of the lanes active, standing for the
   later bounces) and the chain kernel on each chain of the slice on
   1,048,576 lanes and every shape the integrators call (and rows wider
   than a tile, rows a thread takes alone, ragged chains) on 32,768, 4,093,
   7 and 1, bit for bit, each timed with its bound, the gather with its
   issue-slot bound (its SASS per (lane, point) by ``sass_loop_stats``,
   nvidia-smi's SM clock read while it is timed), registers, blocks per
   SM, lanes a warp and the share of tiles on the checked terms, the chain
   (its nested blocks, IGI's picks, and ``key_uniforms``' AO directions and
   bounce block) with its issue-slot bound
   (``keyed_tile_timed``), registers and blocks per SM; each integrator on
   the tiny scene closed into a room with two subsurface boxes at 16²,
   card vs CPU;
16. PRT, probes and the Metropolis renderer — killeroo-simple at its
   golden's 256² film: the mutation kernel (``mlt_mutate``) against
   ``mutate_plain`` bit for bit on 16,384 × 60 and ragged shapes, its
   large-only mode on the bootstrap's 100,000 × 60, timed with its bound;
   ``Renderer "metropolis"`` with 2 mutations per pixel (16,384 chains × 8
   iterations), bidirectional and unidirectional under ``path`` depth 5
   (b, the bootstrap's seconds, mutations/s, acceptance, launches,
   threefry torch ops on the card: none; one iteration profiled);
   ``diffuseprt`` and ``glossyprt`` (the 4,096-ray projection's seconds
   and c_in's first band; a 1-spp frame counted as in phase 7, one chunk
   profiled); ``Renderer "createprobes"`` at spacing 250 and
   ``useprobes`` reading its file (likewise); the tiny scene at 16² under
   the three integrators card vs CPU (its 2 × 2 × 2 probe files, made on
   each device, compared), ``trace_bidir`` per lane on one shared array
   and one Metropolis step from one shared state, card vs CPU;
17. differentiable rendering, resume, the sharded renderer, tools —
   killeroo-simple at 512² under ``path`` depth 5: the forward pass
   (``radiance_loss``) timed, then ``value_and_grads`` (kd, emit) and
   ``grad_wrt_materials`` in 32,768-lane chunks, two passes each (seconds
   per pass, gradient against forward paths/s, launches per chunk of each
   pass, pass 2's peak memory per chunk, threefry torch ops on the card:
   none); every gradient finite, the killeroo row's kd and the light's
   emit non-zero; central differences (float64 sums, eps 1e-3, rtol 5e-2)
   on kd bins 0, 15, 31 at depth 4 and emit bin 16 at depth 5, kd bin 15
   at depth 5 logged; chunk 0's gradients through the kernels against the
   plain walks (rtol 1e-5), and one chunk of pass 2 profiled; the tiny
   scene's gradients at 16², card vs CPU; ``grad_wrt_textures`` on
   ``goldens/metal.pbrt`` (phase 10's files); killeroo at 128², 4 spp,
   resumed from a 2-wave checkpoint, bit for bit against the uninterrupted
   render; ``render_sharded`` at 256² in an ``nccl`` group of one against
   ``render``; ``exrdiff`` and ``datdiff`` on the phase's outputs, exit
   codes checked;
18. volumes under the remaining kinds — killeroo-simple in phase 13's fog
   (emission) at 256² under ``irradiancecache`` (1 spp, counted as in
   phase 7, one chunk profiled: the nested traces' media draws), under the
   Metropolis renderer (2 mutations per pixel, 16,384 chains × 8
   iterations, a 32,768-vector bootstrap) bidirectional, unidirectional
   under ``path`` depth 5 and under ``ambientocclusion`` (mutations/s,
   launches per evaluation, the chains' media and AO draws once per
   evaluation, threefry torch ops on the card: none); ``value_and_grads``
   (kd, emit) at 512² under ``path`` depth 5 in 32,768-lane chunks with the
   media block (gradient paths/s, launches per chunk, the loss equal to the
   forward's), at depth 4 with a central difference on kd bin 15, and at
   256² under ``igi``; the tiny scene in a fog at 16², card vs CPU: the
   cache under emission and single scattering, the three Metropolis
   evaluations per lane, the ``path`` and ``igi`` gradients;
19. the ``kernels`` JSON line (see PERF.md for the fields), then the result.

The real-size scene is ``goldens/killeroo-simple.pbrt`` (its text is kept
here) at 512²; each ``Include "geometry/killeroo.pbrt"`` (geometry not in
the repository) becomes a ``trianglemesh`` generated with numpy from a
fixed seed: a radially displaced geodesic icosphere of 64,980 triangles,
about 100 units across.

Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without ``pbrt_torch/`` beside it, it exits 1 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import socket
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CHUNK = 1 << 15
N_LANES = 1 << 20
BRUTE_LANES = 4096
#: float operations of one interpret step, counted from traverse.cu:
#: node row — per slot 6 sub + 6 mul (slabs), 10 min/max, 2 compares,
#: 1 select, then 19 compare-exchanges; leaf row — per slot 45 arithmetic
#: operations incl. one division (Möller–Trumbore), 8 compares, 1 select
OPS_NODE_STEP = 8 * 25 + 19
OPS_LEAF_STEP = 8 * 54
#: bytes a traversal lane must read and write once: o, d, 1/d (36), tmin,
#: tmax (8), seed t/prim/b1/b2 (16) in; t/prim/b1/b2 (16) out
LANE_BYTES_TRAVERSE = 76
#: standalone step lane besides its row: o/d/inv (36), tmin/t_best (8),
#: is_node/act (2) in; refs (32), n_hit, tsel, psel, b1, b2 (20) out
LANE_BYTES_STEP = 36 + 8 + 2 + 32 + 20
#: the bytes of a row that a step must read: a node step its 7 slot-major
#: fields of 8 floats (6 bounds and the refs), a leaf step all 10
NODE_ROW_BYTES = 7 * 8 * 4
LEAF_ROW_BYTES = 10 * 8 * 4
#: a motion step also reads the deltas of the fields it lerps: a node row's
#: 6 box fields, a leaf row's 9 triangle fields; each lerp is a multiply and
#: an add per slot and field
NODE_DELTA_BYTES = 6 * 8 * 4
LEAF_DELTA_BYTES = 9 * 8 * 4
OPS_NODE_LERP = 8 * 6 * 2
OPS_LEAF_LERP = 8 * 9 * 2
#: a motion node step also reads its row's time boxes (wide.time_boxes):
#: 6 box fields and their 6 deltas of 8 floats; per slot it lerps the 6
#: (a multiply and an add each) and slab-tests the box against [tmin,
#: inf): 6 sub + 6 mul, 10 min / max, the tmin max and 1 compare
TBOX_BYTES = 6 * 8 * 4
TBOX_DELTA_BYTES = 6 * 8 * 4
OPS_TBOX_LERP = 8 * 6 * 2
OPS_TBOX_TEST = 8 * 24
#: per lane, besides the traversal's: the shutter weight in (motion), the
#: instance out (instance phase)
LANE_BYTES_MOTION = LANE_BYTES_TRAVERSE + 4
LANE_BYTES_INSTANCES = LANE_BYTES_TRAVERSE + 4
#: an instance-table row the phase reads: w2o's 12 used floats, the box's
#: 6 and the root
INSTANCE_ROW_BYTES = (12 + 6 + 1) * 4
#: per lane and instance, the box test (6 sub, 6 mul, 10 min/max, 2 max/min
#: with tmin and t_best, 1 compare); per walked lane and instance, the ray's
#: transform (18 mul, 15 add) and 1/d (3 divisions, 3 adds, 6 compares)
OPS_PRUNE = 6 + 6 + 10 + 2 + 1
OPS_INSTANCE_RAY = 18 + 15 + 3 + 3 + 6
RNG_DEPTH = 5
#: rounds of queued_ms for the keyed kernels (median, min–max)
RNG_ROUNDS = 5
#: pixel indices at and above 2**31 (uint32 wraparound), as the CPU tests'
PIXELS_WRAP = (0, 1, 5, 63, 4095, 262143, 2**31 - 1, 2**31, 2**31 + 3, 2**32 - 1)
#: the least integer operations of the keyed functions (rng.cu). One
#: threefry-2x32 hash of a counter pair (0, c): 20 rounds of add, rotate and
#: xor; the first key injection's one add (the high word starts as the key
#: word); 5 injections of 2 adds of the key schedule's words. A key's
#: schedule, once per key: k0 ^ k1 ^ C (2 xors) and the 5 words k + i the
#: injections add. Each lane derives 3 keys (pixel, sample, tag), then per
#: uniform hashes once and takes the xor of the two words, a shift and an
#: or (integer) and subtracts 1 (float); per scramble word, hash and xor.
#: The camera columns: per lane 5 xors of a scramble word with brev(n) or
#: the Sobol' word of n (both per launch), then per column a conversion, a
#: multiply by 2**-32 and a min (float)
OPS_HASH = 20 * 3 + 1 + 5 * 2
OPS_KEY_SCHEDULE = 2 + 5
OPS_LANE_KEY = 3 * (OPS_HASH + OPS_KEY_SCHEDULE)
OPS_PER_UNIFORM = OPS_HASH + 3
OPS_PER_SCRAMBLE = OPS_HASH + 1
OPS_CAMERA_I32 = 5
OPS_CAMERA_F32 = 5 * 3
#: an AO lane derives 2 keys (pixel, sample); per AO sample it forms the tag
#: s·16 + 3 (2), folds it in (a key) and draws 2 uniforms
OPS_AO_LANE_KEY = 2 * (OPS_HASH + OPS_KEY_SCHEDULE)
OPS_PER_AO_SAMPLE = 2 + OPS_HASH + OPS_KEY_SCHEDULE + 2 * OPS_PER_UNIFORM
#: AO samples the AO kernel is checked at, and the one it is timed at (the
#: ambient-occlusion render's, ``nsamples`` 4)
AO_CHECKED = (1, 4, 64)
AO_TIMED = 4
#: tolerance of the card-vs-CPU renders of the tiny scene
REF_RTOL, REF_ATOL, REF_PIXELS, REF_BIN_REL = 1e-4, 1e-6, 0.99, 1e-3
#: the per-bin mean's tolerance for phase 12's 16² references: each view
#: sees the light sphere (L = 2,000) in a few of its 8 × 256 lanes, and one
#: such lane that the card and the CPU send apart moves a bin's mean by
#: ~1.5e-3: a lens lane at an aperture rim or the TIR limit (the trace's
#: acos, atan, sin and cos round differently by an ulp), an orthographic
#: lane on the sphere's rim (its origin comes out of a matrix product
#: summed in another order); PR 10's chip runs read 1.81e-3 (D-Gauss) and
#: 1.39e-3 (orthographic) with 99.71% and 99.95% of the pixels close
REF_BIN_REL_CAMERAS = 5e-3
#: the same for the spectral renderer's 16² reference at 4 bands: each
#: band's bins come from their own traces, so the largest bin difference is
#: the worst of 4 such sets (PR 10, call 4: 5.25e-3, with 99.12% of the
#: pixels and more of the (pixel, band) paths close)
REF_BIN_REL_SPECTRAL = 1e-2
#: waves (and render seeds) pooled in each 16² textured comparison: a
#: textured killeroo-scale scene has a few lanes in a thousand whose later
#: bounces an ulp of difference sends elsewhere (unfiltered lookups past the
#: first hit); 256 lanes would hold the 99% rule to 2 such lanes, 2,048 to 20
TEXTURE_REF_WAVES = 8
#: depth of the 512² materials-and-environment and texture-kinds frames
#: (phases 9 and 10; cut from 5): a profiled frame's processing time
#: grows with its launches (~346,000 at depth 5 on the materials scene,
#: ~86 s each), and the script stays within half its time limit
SCENE_DEPTH = 2

KILLEROO_SIMPLE = """
LookAt 400 20 30   0 63 -110   0 0 1
Rotate -5 0 0 1
Camera "perspective" "float fov" [39]
Film "image" "integer xresolution" [512] "integer yresolution" [512]
    "string filename" "killeroo-simple.dat"
Sampler "lowdiscrepancy" "integer pixelsamples" [8]
SurfaceIntegrator "directlighting"
WorldBegin
AttributeBegin
Material "matte" "color Kd" [0 0 0]
Translate 150 0  20
Translate 0 120 0
AreaLightSource "area"  "color L" [2000 2000 2000] "integer nsamples" [8]
Shape "sphere" "float radius" [3]
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [.5 .5 .8]
  Translate 0 0 -140
Shape "trianglemesh" "point P" [ -1000 -1000 0 1000 -1000 0 1000 1000 0 -1000 1000 0 ]
      "float uv" [ 0 0 5 0 5 5 0 5 ]
	"integer indices" [ 0 1 2 2 3 0]
Shape "trianglemesh" "point P" [ -400 -1000 -1000   -400 1000 -1000   -400 1000 1000 -400 -1000 1000 ]
      "float uv" [ 0 0 5 0 5 5 0 5 ]
        "integer indices" [ 0 1 2 2 3 0]
AttributeEnd
AttributeBegin
Scale .5 .5 .5
Rotate -60 0 0 1
    Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.5 .5 .5]
        "float roughness" [.025]
Translate 100 200 -140
    @MESH@
    Material "plastic" "color Ks" [.3 .3 .3] "color Kd" [.4 .5 .4]
        "float roughness" [.15]
Translate -200 0 0
    @MESH@
AttributeEnd
WorldEnd
"""

#: what the lights-and-quadrics scene adds to the real-size scene, right
#: after WorldBegin: a point, a spot and a distant light, an emissive
#: two-triangle quad facing down, and a disk, cylinder, cone, paraboloid and
#: hyperboloid standing on the floor in front of the blobs
LIGHTS_AND_QUADRICS = """
AttributeBegin
LightSource "point" "color I" [60000 60000 60000] "point from" [200 -80 60]
LightSource "spot" "color I" [200000 200000 200000] "point from" [250 60 150]
    "point to" [60 60 -140] "float coneangle" [20] "float conedeltaangle" [5]
LightSource "distant" "color L" [.4 .4 .4] "point from" [1 1 1] "point to" [0 0 0]
AttributeEnd
AttributeBegin
AreaLightSource "area" "color L" [30 30 30]
Material "matte" "color Kd" [0 0 0]
Shape "trianglemesh" "point P" [0 150 60  80 150 60  80 230 60  0 230 60]
    "integer indices" [0 2 1 0 3 2]
AttributeEnd
AttributeBegin
Material "plastic" "color Kd" [.3 .4 .2] "color Ks" [.4 .4 .4] "float roughness" [.05]
AttributeBegin
Translate 120 -40 -100
Rotate 60 0 1 0
Shape "disk" "float radius" [18] "float innerradius" [4]
AttributeEnd
AttributeBegin
Translate 120 0 -140
Shape "cylinder" "float radius" [10] "float zmin" [0] "float zmax" [45] "float phimax" [300]
AttributeEnd
AttributeBegin
Translate 120 40 -140
Shape "cone" "float radius" [14] "float height" [40]
AttributeEnd
AttributeBegin
Translate 120 80 -140
Shape "paraboloid" "float radius" [14] "float zmin" [0] "float zmax" [35]
AttributeEnd
AttributeBegin
Translate 120 120 -115
Scale 10 10 12
Shape "hyperboloid" "float zmin" [-2] "float zmax" [2]
AttributeEnd
AttributeEnd
"""
#: icosphere frequency of the blob in the 16² lights-and-quadrics scene the
#: CPU renders (2,880 triangles)
SMALL_BLOB_FREQ = 12

#: what the materials-and-environment scene adds to the real-size scene,
#: right after WorldBegin: an infinite light with a generated lat-long map,
#: a projection and a goniometric light with generated maps, and two rows
#: of spheres ~206 units in front of the camera in shinymetal, anisoward,
#: Oren–Nayar matte, translucent, a mix of a named plastic and a named
#: glass, and the two measured formats (@DIR@ is the directory of the
#: generated files). Near and large, so a float32 sphere hit is well
#: conditioned (at killeroo's distances, ~390 units for a radius of 14, a
#: hit point moves by 7e-6 of t between two roundings of the quadratic)
MATERIALS_AND_ENV = """
LightSource "infinite" "color L" [1 1 1] "string mapname" ["@DIR@/env.exr"]
AttributeBegin
Translate 60 60 160
Rotate 180 1 0 0
LightSource "projection" "color I" [150000 150000 150000] "float fov" [30]
    "string mapname" ["@DIR@/projection.exr"]
AttributeEnd
AttributeBegin
Translate 20 140 60
LightSource "goniometric" "color I" [40000 40000 40000] "string mapname" ["@DIR@/gonio.exr"]
AttributeEnd
MakeNamedMaterial "red plastic" "string type" ["plastic"] "color Kd" [.6 .1 .1]
    "color Ks" [.3 .3 .3] "float roughness" [.02]
MakeNamedMaterial "clear glass" "string type" ["glass"] "float index" [1.5]
AttributeBegin
Material "shinymetal" "color Ks" [.8 .6 .3] "color Kr" [.5 .5 .5] "float roughness" [.05]
Translate 196 -6 -18
Shape "sphere" "float radius" [14]
AttributeEnd
AttributeBegin
Material "anisoward" "color Kd" [.2 .3 .5] "color Ks" [.4 .4 .4] "float alphaU" [.05]
    "float alphaV" [.3]
Translate 199 25 -18
Shape "sphere" "float radius" [14]
AttributeEnd
AttributeBegin
Material "matte" "color Kd" [.7 .7 .5] "float sigma" [20]
Translate 203 57 -18
Shape "sphere" "float radius" [14]
AttributeEnd
AttributeBegin
Material "translucent" "color Kd" [.5 .6 .4] "color Ks" [.3 .3 .3] "color reflect" [.5 .5 .5]
    "color transmit" [.5 .5 .5] "float roughness" [.1]
Translate 206 89 -18
Shape "sphere" "float radius" [14]
AttributeEnd
AttributeBegin
Material "mix" "string namedmaterial1" ["red plastic"] "string namedmaterial2" ["clear glass"]
    "float amount" [.3]
Translate 211 8 -56
Shape "sphere" "float radius" [14]
AttributeEnd
AttributeBegin
Material "measured" "string filename" ["@DIR@/generated.brdf"]
Translate 214 40 -56
Shape "sphere" "float radius" [14]
AttributeEnd
AttributeBegin
Material "measured" "string filename" ["@DIR@/generated.merl"]
Translate 217 72 -56
Shape "sphere" "float radius" [14]
AttributeEnd
"""
#: killeroo-simple's materials as the materials-and-environment scene
#: changes them: the floor in substrate (goldens/metal.pbrt's, untextured),
#: the back wall in uber with Kr and Kt, one blob in glass, the other in
#: metal (default copper)
MATERIALS_SWAPS = (
    ('Material "matte" "color Kd" [.5 .5 .8]',
     'Material "substrate" "color Kd" [.5 .5 .8] "color Ks" [.5 .5 .5]\n'
     '    "float uroughness" [.05] "float vroughness" [.05]'),
    ('Shape "trianglemesh" "point P" [ -400',
     'Material "uber" "color Kd" [.3 .3 .3] "color Ks" [.2 .2 .2] "color Kr" [.2 .2 .2]\n'
     '    "color Kt" [.3 .3 .3] "float roughness" [.05] "float index" [1.5]\n'
     'Shape "trianglemesh" "point P" [ -400'),
    ('Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.5 .5 .5]\n        "float roughness" [.025]',
     'Material "glass" "float index" [1.5]'),
    ('Material "plastic" "color Ks" [.3 .3 .3] "color Kd" [.4 .5 .4]\n        "float roughness" [.15]',
     'Material "metal" "float roughness" [.001]'),
)


def write_material_data(directory: str, seed: int = 11):
    """The materials-and-environment scene's files, from a fixed numpy seed:
    ``env.exr`` (512×256 lat-long: a sky gradient with a bright sun patch,
    so its Distribution2D is far from uniform), ``projection.exr`` (64×64
    a soft ring) and ``gonio.exr`` (64×32 lobes), ``generated.brdf`` (2,000
    scattered spectral samples of a glossy lobe, 8 wavelengths) and
    ``generated.merl`` (a full 90×90×180 table that falls off with θh)."""
    from pbrt_torch.film.imageio import write_exr

    rng = np.random.default_rng(seed)
    # smooth maps: a direction or hit point an ulp away (XLA contracts
    # multiply-adds, the port does not) then moves a lookup by less than the
    # parity tests' tolerance, unless it crosses a texel edge of the sky
    v = (np.arange(256) + 0.5) / 256
    u = (np.arange(512) + 0.5) / 512
    env = np.empty((256, 512, 3), np.float32)
    env[:] = (0.25 + 0.75 * (1.0 - v))[:, None, None] * np.array([0.5, 0.7, 1.0], np.float32)
    sun = ((v[:, None] - 0.3) ** 2 + (u[None, :] - 0.6) ** 2) < 0.0004
    env[sun] = (300.0, 280.0, 240.0)
    write_exr(os.path.join(directory, "env.exr"), env, half=False)
    yy, xx = np.mgrid[0:64, 0:64] / 63.0
    ring = 0.5 + 0.5 * np.cos(6.0 * np.hypot(xx - 0.5, yy - 0.5))
    proj = np.stack([ring, ring * yy, 1.0 - ring * xx], -1).astype(np.float32)
    write_exr(os.path.join(directory, "projection.exr"), proj, half=False)
    th, ph = np.mgrid[0:32, 0:64]
    lobe = (np.cos(th * np.pi / 31) ** 2 * (1.2 + np.sin(3 * ph * 2 * np.pi / 64)))[..., None]
    write_exr(os.path.join(directory, "gonio.exr"),
              (lobe * np.array([1.0, 0.9, 0.7])).astype(np.float32), half=False)
    n, wls = 2000, np.linspace(400.0, 700.0, 8)
    ti, to = np.arccos(rng.random(n)), np.arccos(rng.random(n))
    pi_, po = rng.uniform(0, 2 * np.pi, n), rng.uniform(0, 2 * np.pi, n)
    wi = np.stack([np.sin(ti) * np.cos(pi_), np.sin(ti) * np.sin(pi_), np.cos(ti)], -1)
    wo = np.stack([np.sin(to) * np.cos(po), np.sin(to) * np.sin(po), np.cos(to)], -1)
    refl = wo * np.array([-1.0, -1.0, 1.0])
    gloss = np.exp(-((wi - refl) ** 2).sum(-1) / 0.05)
    spd = 0.15 + (0.8 * gloss)[:, None] * np.linspace(1.0, 0.4, 8)[None, :]
    rows = np.concatenate([np.stack([ti, pi_, to, po], -1), spd], 1)
    with open(os.path.join(directory, "generated.brdf"), "w") as f:
        f.write(f"8\n{' '.join(f'{w:g}' for w in wls)}\n")
        f.write("\n".join(" ".join(f"{x:.6g}" for x in r) for r in rows) + "\n")
    th_h = np.arange(90)[:, None, None] / 89.0
    base = np.broadcast_to(0.05 + 2.5 * np.exp(-(th_h / 0.12) ** 2), (90, 90, 180))
    tint = np.array([1.0, 0.85, 0.6])[:, None, None, None]
    table = (1500.0 * base[None] * tint).reshape(3, -1)
    with open(os.path.join(directory, "generated.merl"), "wb") as f:
        f.write(np.array([90, 90, 180], "<i4").tobytes())
        f.write(table.astype("<f8").tobytes())


def materials_scene_text(text: str, directory: str, integrator: str = "path") -> str:
    """A real-size scene's text made the materials-and-environment scene
    (files in ``directory``) with the given surface integrator."""
    for old, new in MATERIALS_SWAPS:
        if old not in text:
            raise ValueError(f"the scene text has no {old!r}")
        text = text.replace(old, new, 1)
    text = text.replace('SurfaceIntegrator "directlighting"', f'SurfaceIntegrator "{integrator}"')
    return text.replace("WorldBegin", "WorldBegin" + MATERIALS_AND_ENV.replace(
        "@DIR@", directory), 1)

#: the keyed-normals kernel's float operations per normal: the uniform
#: (subtract 1, multiply by 2, add minval, max), -u² (2), log1pf (counted
#: as 16: libdevice's range reduction and polynomial), the negation, the
#: branch test and w - 2.5 or √w - 3 (2), 8 Horner steps (2 each), p·u and
#: ·√2
OPS_NORMAL_F32 = 4 + 2 + 16 + 1 + 1 + 2 + 8 * 2 + 2
#: a lens lane's normals kernel integer work: the (pixel, sample) key (2
#: keys), then per tag its fold-in (a key and the tag's add) and 2 words
OPS_NORMALS_LANE_KEY = 2 * (OPS_HASH + OPS_KEY_SCHEDULE)
OPS_PER_NORMAL_TAG = 1 + OPS_HASH + OPS_KEY_SCHEDULE + 2 * OPS_PER_UNIFORM
#: the realistic camera's tags (D-Gauss: 11 rows) the kernel is timed at
NORMAL_TAGS = 11
#: the D-Gauss spectral frame's film (512² through PR 15: 32 band-waves per
#: chunk, ~31–53 s a frame; cut to keep the script inside its limit)
SPECTRAL_RES = 256


def lens_phase(dev, drive, profile_frame, card_vs_cpu, data_dir):
    """Phase 12: killeroo-simple through the fork's lens cameras and the
    spectral renderer, the keyed-normals kernel against its plain version
    and timed, the traversal kernels on the lens rays (dead lanes
    included), the other cameras and the cameras renderer, and the 16²
    references. → the keyed-normals kernel's entry of the kernels line."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.core import geometry as geom
    from pbrt_torch.core import rng
    from pbrt_torch.core import transform as xf
    from pbrt_torch.film import film as film_mod
    from pbrt_torch.integrators.path import trace_radiance
    from pbrt_torch.renderers import dispatch
    from pbrt_torch.renderers import sampler as sampler_mod
    from pbrt_torch.renderers.spectral import render_spectral, spectral_options, spectral_wave
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build
    from pbrt_torch.utils import native
    from pbrt_torch.utils.timing import cuda_ms

    sync = torch.cuda.synchronize
    t_phase = time.time()
    write_lens_data(data_dir)
    text, _ = real_scene_text()

    def chunk_wave(b, bands=0):
        """One chunk's wave of ``b`` (chunk 0, sample 0): the sampler's, or
        band 0 of ``bands`` of the spectral renderer's; → a callable."""
        xs, ys, pix, mask, root, scr = sampler_mod.pixel_chunks(b, 3, CHUNK)
        u = sampler_mod.wave_uniforms(b.integrator, root, pix[0], scr[0], 0)
        noise = sampler_mod.camera_noise(b.camera, root, pix[0], 0)
        st = film_mod.init_film(b.film_config, dev)
        if bands:
            cfg = spectral_options(b)[2]
            return lambda: spectral_wave(st, b.scene, b.camera, b.filter_table, xs[0], ys[0],
                                         b.integrator, b.film_config, u, noise, 0, bands, cfg,
                                         sample_scale=mask[0])
        return lambda: sampler_mod.render_wave(st, b.scene, b.camera, b.filter_table, xs[0],
                                               ys[0], b.integrator, b.film_config, u,
                                               sample_scale=mask[0], noise=noise)

    def alive_share(b, n=CHUNK):
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        u = torch.rand((5, n), generator=gen, device=dev)
        r = b.camera.generate_rays(u[0] * b.film_config.xres, u[1] * b.film_config.yres,
                                   u[2], u[3], u[4])
        return float((r.direction.norm(dim=-1) > 0.5).float().mean())

    # ---- (a) the D-Gauss lens, diffraction and chromatic aberration, 32 bands
    t0 = time.time()
    spectral = 'Renderer "spectral" "integer nWaveBands" [32]'
    built = build(load_scene_string(lens_scene_text(real_scene_text(res=SPECTRAL_RES)[0],
                                                    "realisticDiffraction", data_dir,
                                                    spectral)), device=dev)
    cam, ic, fc = built.camera, built.integrator, built.film_config
    n_bands, method, _ = spectral_options(built)
    log("scene", f"killeroo-simple through the D-Gauss F/2 (50 mm, {len(cam.el_radius)} rows, "
        f"stop {cam.el_aperture[cam.el_radius == 0][0]:g} mm, f/{cam.f_stop:.3f}, film at "
        f"{cam.film_distance:g} mm, diffraction {cam.diffraction}, chromatic "
        f"{cam.chromatic}): {built.renderer_name} renderer, {n_bands} bands, {method}; "
        f"{ic.kind} depth {ic.max_depth}, {fc.xres}x{fc.yres}; header focal length "
        f"{fc.focal_length:g} mm, f-stop {fc.f_stop:.4f}; lanes alive "
        f"{alive_share(built):.4f}; built in {time.time() - t0:.1f} s")
    if not (built.renderer_name == "spectral" and n_bands == 32 and method == "singleDirection"
            and (ic.kind, ic.max_depth) == ("directlighting", 5) and (fc.xres, fc.yres) ==
            (SPECTRAL_RES, SPECTRAL_RES) and len(cam.noise_tags) == NORMAL_TAGS
            and fc.focal_length == 50.0):
        raise SystemExit("the D-Gauss spectral scene did not build as written")
    film, sec, launches, _ = drive("killeroo-simple through the D-Gauss lens (spectral, 32 "
                                   "bands)", built, 1, warm=False, renderer=render_spectral,
                                   bands=n_bands)
    normal_launches = launches["keyed_camera_normals"]
    lit = (film.pixels.sum((0, 1)) > 0).tolist()
    log("lens", f"D-Gauss spectral frame: {sum(lit)} of {len(lit)} bins lit; camera-normals "
        f"launches {normal_launches} (one per sample and chunk, shared by the 32 bands)")
    if not all(lit):
        raise SystemExit("the spectral frame left a band empty")
    profile_frame("D-Gauss lens, spectral band 0 of chunk 0", built, sec * 1e3,
                  run=chunk_wave(built, n_bands), scale=chunks_of(built) * n_bands)

    # the traversal kernels on the frame's band-0 lens rays, dead lanes included
    xs, ys, pix, mask, root, scr = sampler_mod.pixel_chunks(built, 0, CHUNK)
    rays = []
    for c in range(xs.shape[0]):
        u = sampler_mod.wave_uniforms(ic, root, pix[c], scr[c], 0)
        r = cam.generate_rays(xs[c].float() + u[:, 0], ys[c].float() + u[:, 1], u[:, 2],
                              u[:, 3], u[:, 4], wavelength=400.0,
                              noise=sampler_mod.camera_noise(cam, root, pix[c], 0))
        rays.append((r.origin, r.direction))
    o = torch.cat([r[0] for r in rays]).contiguous()
    d = torch.cat([r[1] for r in rays]).contiguous()
    dead = d.norm(dim=-1) == 0.0
    g = built.scene.geometry
    inv = isect.make_inv_dir(d).contiguous()
    R = o.shape[0]
    tmin = torch.zeros(R, device=dev)
    tmax = torch.full((R,), float("inf"), device=dev)
    q = [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmax)]
    eq = {}
    for any_hit in (False, True):
        args = (g.wide_rows, g.wide_stack, o, d, inv, tmin, tmax, *q)
        k = tc.traverse(*args, any_hit=any_hit)
        p = tc.traverse_plain(*args, any_hit=any_hit)
        sync()
        eq["any" if any_hit else "closest"] = (
            all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(k, p)),
            all(torch.equal(a[dead].view(torch.int32), b[dead].view(torch.int32))
                for a, b in zip(k, p)), int((p[1][dead] >= 0).sum()))
    sel = torch.nonzero(dead).squeeze(1)[:CHUNK]
    u_dead = sampler_mod.wave_uniforms(ic, root, pix.reshape(-1)[sel], scr.reshape(-1, 6)[sel], 0)
    L_dead = trace_radiance(built.scene, geom.Ray.make(o[sel].contiguous(), d[sel].contiguous()),
                            ic, u_dead)[0]
    log("lens", f"traversal kernels vs plain on the frame's {R} lens rays at 400 nm "
        f"({int(dead.sum())} dead, direction 0; inverse direction ±1e20 there, finite slabs): "
        + ", ".join(f"{k_} equal bit for bit {v[0]} (dead lanes {v[1]}, hits among them {v[2]}: "
                    "the light sphere's solve at t ~1e24, as in the JAX package)"
                    for k_, v in eq.items())
        + f"; radiance of {sel.numel()} dead lanes: max {float(L_dead.abs().max()):.3g}")
    if not all(v[0] and v[1] for v in eq.values()) or float(L_dead.abs().max()) != 0.0:
        raise SystemExit("the traversal kernels disagree on lens rays, or dead lanes add light")

    # ---- the keyed-normals kernel against its plain version, and timed -------
    pix_all = torch.arange(N_LANES, dtype=torch.int64, device=dev)
    pix_wrap = torch.cat([torch.tensor(PIXELS_WRAP, dtype=torch.int64, device=dev), pix_all])
    err_n, n_cases = 0.0, 0
    for p_, sample, tag0, n_tags in ([(pix_all, s_, rng.REALISTIC_NOISE_TAG, NORMAL_TAGS)
                                      for s_ in (0, 3, 2**31 + 1)]
                                     + [(pix_all, 0, rng.IDEAL_NOISE_TAG, 1)]
                                     + [(pix_wrap[:n].contiguous(), 3, tag0_, t_)
                                        for n in (1, 7, 4093)
                                        for tag0_, t_ in ((1000, 11), (2000, 1), (1000, 17),
                                                          (2**32 - 33, 33))]):
        kn = rng.camera_normals(root, p_, sample, tag0, n_tags)
        pn = rng.camera_normals_plain(root, p_, sample, tag0, n_tags)
        if not torch.equal(kn.view(torch.int32), pn.view(torch.int32)):
            raise SystemExit(f"keyed_camera_normals disagrees with its plain version on "
                             f"{p_.numel()} lanes, sample {sample}, tags {tag0} + {n_tags}")
        err_n = max(err_n, float((kn - pn).abs().max()))
        n_cases += 1
    big = rng.camera_normals(root, pix_all, 0, rng.REALISTIC_NOISE_TAG, NORMAL_TAGS)
    sync()
    log("rng", f"keyed_camera_normals vs plain: {n_cases} cases ({N_LANES} lanes x 11 tags at "
        f"samples 0, 3, 2**31 + 1, and the ideal camera's tag; 1, 7 and 4,093 lanes with pixel "
        f"indices up to 2**32 - 1 at 1, 11, 17 and 33 tags): equal bit for bit; on {N_LANES} "
        f"lanes mean {float(big.double().mean()):.5f}, std {float(big.double().std()):.5f}, "
        f"range [{float(big.min()):.3f}, {float(big.max()):.3f}]")
    del big
    lib = native.kernel_lib("rng.cu")
    timed_n = {}
    for label in NORMALS_TIMED:
        case = rng_timed_case(label, dev)
        timed_n[label] = dict(case=case, **rng_case_timed(case, lib))
    main_n = timed_n["32,768 x 11"]
    n_plain = cuda_ms(main_n["case"]["plain"], n=5, warm=1)
    nt, n_bound, n_by = main_n, main_n["bound_ms"], main_n["bound_by"]

    # ---- (b) the schematic eye, the sampler renderer ----------------------
    t0 = time.time()
    eye = build(load_scene_string(lens_scene_text(text, "realisticEye", data_dir)), device=dev)
    log("scene", f"killeroo-simple through the schematic eye ({len(eye.camera.el_rx)} rows, "
        f"pupil {eye.camera.pupil_diameter:g} mm, retina radius {eye.camera.retina_radius:g} "
        f"mm): {eye.renderer_name} renderer, media spectra ior1..ior4 at 400 nm "
        f"{[round(float(v), 4) for v in eye.camera.ior_spectra[:4, 0]]}; lanes alive "
        f"{alive_share(eye):.4f}; built in {time.time() - t0:.1f} s")
    _, sec, _, _ = drive("killeroo-simple through the schematic eye", eye, 1, warm=False)
    profile_frame("schematic eye, chunk 0", eye, sec * 1e3, run=chunk_wave(eye),
                  scale=chunks_of(eye))
    del eye

    # ---- (c) the other cameras, then the cameras renderer -------------------
    for name_ in ("idealDiffraction", "orthographic", "pinhole", "environment"):
        b = build(load_scene_string(lens_scene_text(text, name_, data_dir)), device=dev)
        _, sec, lk, _ = drive(f"killeroo-simple through the {name_} camera", b, 1, warm=False)
        if name_ == "idealDiffraction":
            normal_launches += lk["keyed_camera_normals"]
        profile_frame(f"{name_} camera, chunk 0", b, sec * 1e3, run=chunk_wave(b),
                      scale=chunks_of(b))
    mats = [np.linalg.inv(xf.look_at(eye_, (0.0, 63.0, -110.0), (0.0, 0.0, 1.0)))
            for eye_ in ((400.0, 20.0, 30.0), (300.0, -180.0, 60.0))]
    with open(os.path.join(data_dir, "cams.txt"), "w") as f:
        f.write("\n".join(" ".join(f"{v:.9g}" for v in m.ravel()) for m in mats))
    small64, _ = real_scene_text(res=64)
    views = build(load_scene_string(lens_scene_text(
        small64, 'Camera "perspective" "float fov" [39]', data_dir,
        f'Renderer "cameras" "string cameraTransforms" ["{data_dir}/cams.txt"]')), device=dev)
    t0 = time.time()
    outs = dispatch.render_scene(views, spp=1, outfile=os.path.join(data_dir, "views.dat"))
    sync()
    sums = [float(film_mod.read_dat(p_)[0].sum()) for p_ in outs if p_.endswith(".dat")]
    log("render", f"cameras renderer, 64x64, 2 transforms, 1 spp: {time.time() - t0:.3f} s, "
        f"outputs {[os.path.basename(p_) for p_ in outs]}, film sums {sums}")
    if ([os.path.basename(p_) for p_ in outs] != ["views_cam0.dat", "views_cam0.exr",
                                                 "views_cam1.dat", "views_cam1.exr"]
            or not all(v > 0 for v in sums) or sums[0] == sums[1]):
        raise SystemExit("the cameras renderer did not render its two views")

    # ---- (d) 16² references ----------------------------------------------
    small, _ = real_scene_text(SMALL_BLOB_FREQ, res=16)
    for name_ in LENS_CAMERAS:
        card_vs_cpu(f"{name_} camera ({20 * SMALL_BLOB_FREQ ** 2}-triangle blobs)",
                    lens_scene_text(small, name_, data_dir), spp=1, chunk_pixels=256,
                    waves=TEXTURE_REF_WAVES, bin_tol=REF_BIN_REL_CAMERAS)
    card_vs_cpu(f"D-Gauss lens, spectral renderer, 4 bands ({20 * SMALL_BLOB_FREQ ** 2}"
                "-triangle blobs)", lens_scene_text(
                    small, "realisticDiffraction", data_dir,
                    'Renderer "spectral" "integer nWaveBands" [4]'),
                spp=1, chunk_pixels=256, waves=TEXTURE_REF_WAVES, renderer=render_spectral,
                bin_tol=REF_BIN_REL_SPECTRAL, bands=4)
    log("lens", f"phase 12 took {time.time() - t_phase:.1f} s")
    return dict(name="keyed_camera_normals", route="cuda", source="pbrt_torch/csrc/rng.cu",
                replaces="pbrt_tpu/cameras/realistic.py:248", launches=normal_launches,
                max_abs_err=err_n, ms=nt["ms"], plain_ms=n_plain, bound_ms=n_bound,
                bound_by=n_by, library_ms=None)


#: phase 13's samplers (a): each sampler's line in place of killeroo's
#: lowdiscrepancy one, and adaptive's at 2 and 8 samples
PHASE13_SAMPLERS = ("halton", "bestcandidate", "stratified", "random")
KILLEROO_SAMPLER = 'Sampler "lowdiscrepancy" "integer pixelsamples" [8]'
#: the adaptive frames' film (512² through PR 15; each is a whole 8-wave
#: render, cut to keep the script inside its limit)
ADAPTIVE_RES = 256
ADAPTIVE_SAMPLER = ('Sampler "adaptive" "integer minsamples" [2] "integer maxsamples" [8] '
                    '"string method" ["{}"]')
#: the file:line of each sampler's branch in the JAX package's
#: _sampler_uniforms (XLA ops there, not a Pallas kernel)
SAMPLER_REPLACES = {"halton": "pbrt_tpu/renderers/sampler.py:49",
                    "bestcandidate": "pbrt_tpu/renderers/sampler.py:63",
                    "stratified": "pbrt_tpu/renderers/sampler.py:74",
                    "random": "pbrt_tpu/renderers/sampler.py:84"}
#: the box around the whole killeroo-simple scene (its floor and wall
#: planes reach ±1,000), and the media of (b) and (c): water whose
#: absorption curve (``write_water_curve``, a smooth stand-in for the fork's
#: data, red absorbed most) and σs give a transmittance of about 0.35 from
#: the camera to the killeroos (~430 units), and a homogeneous fog with Le
MEDIA_BOX = '"point p0" [-1100 -1100 -1100] "point p1" [1100 1100 1100]'
WATER_VOLUME = ('Volume "water" ' + MEDIA_BOX + ' "string absorptionCurveFile" ["@CURVE@"] '
                '"string phaseFunctionFile" ["vsf.txt"] "spectrum sigma_s" [395 .0009 715 .0005] '
                '"float g" [.6]')
FOG_VOLUME = ('Volume "homogeneous" ' + MEDIA_BOX + ' "spectrum sigma_a" [395 .0012 715 .0018] '
              '"spectrum sigma_s" [395 .0008 715 .0004] "spectrum Le" [395 .0005 715 .0003] '
              '"float g" [.3]')
#: the 16² references' volumes, one per kind, around the tiny scene
REF_VOLUMES = {
    "homogeneous": 'Volume "homogeneous" "point p0" [-30 -30 -30] "point p1" [30 30 30] '
                   '"spectrum sigma_a" [395 .02 715 .03] "spectrum sigma_s" [395 .03 715 .01] '
                   '"spectrum Le" [395 .01 715 .005] "float g" [.5]',
    "exponential": 'Volume "exponential" "point p0" [-30 -1 -30] "point p1" [30 30 30] '
                   '"float a" [.08] "float b" [.4] "vector updir" [0 1 0] '
                   '"spectrum sigma_a" [395 .5 715 .3] "spectrum sigma_s" [395 .4 715 .6] '
                   '"spectrum Le" [395 .05 715 .1] "float g" [-.3]',
    "volumegrid": 'Volume "volumegrid" "point p0" [-4 -1 -3] "point p1" [4 5 6] '
                  '"integer nx" [3] "integer ny" [2] "integer nz" [2] "float density" '
                  '[.1 .4 .2 .05 .3 .6 .2 .1 .5 .3 .05 .2] "spectrum sigma_a" [395 .2 715 .1] '
                  '"spectrum sigma_s" [395 .2 715 .3] "spectrum Le" [395 .02 715 .04]',
    "water": 'Volume "water" "point p0" [-30 -30 -30] "point p1" [30 30 30] '
             '"string absorptionCurveFile" ["@CURVE@"] "spectrum sigma_s" [395 .03 715 .02] '
             '"float g" [.6]',
}
#: waves (and seeds) pooled per 16² reference (a single-scattering frame
#: traces 32 shadow rays per camera lane, ~2 s on the CPU each), and their
#: per-bin rule: phase 12's (``REF_BIN_REL_CAMERAS``). A few lanes in a
#: thousand get the light (L = 12) on one device and not on the other; one
#: such lane among 1,024 moves a bin's mean by ~2.7e-3. The lanes are
#: logged; those of phase 12, traced call by call
#: (``python -m pbrt_torch.scripts.reference_lanes``), part at a NEE shadow
#: ray that grazes the light sphere, which one device finds occluding itself
REF_WAVES_SAMPLERS, REF_WAVES_EMISSION, REF_WAVES_SINGLE = 8, 4, 3
#: the media block's least operations per lane (rng.cu): the lane key (2
#: keys); per jitter its tag (2), a key and a uniform; under single
#: scattering bounce 0's VOLUME key, then per step its tag, a key and 3
#: uniforms (the float subtract per uniform counted as a float op)
OPS_VOLUME_KEY = OPS_HASH + OPS_KEY_SCHEDULE
OPS_PER_JITTER = 2 + OPS_VOLUME_KEY + OPS_PER_UNIFORM
OPS_PER_STEP = 2 + OPS_VOLUME_KEY + 3 * OPS_PER_UNIFORM


def write_water_curve(path: str) -> str:
    """The water absorption curve of phase 13: two columns (λ in nm, σa
    per scene unit) over 395–715 nm, a logistic rise from blue to red."""
    lam = np.linspace(395.0, 715.0, 65)
    sigma = 0.0007 + 0.0028 / (1.0 + np.exp(-(lam - 590.0) / 30.0))
    np.savetxt(path, np.stack([lam, sigma], -1), fmt="%.7f")
    return path


def media_scene_text(text: str, volume: str, integrator: str) -> str:
    """``text`` with ``volume`` after WorldBegin under the volume
    ``integrator``."""
    return text.replace("WorldBegin", f'VolumeIntegrator "{integrator}"\nWorldBegin\n{volume}', 1)


def camera_to_blob_transmittance(built, dev):
    """(mean, min, max) over bins of the transmittance from the camera to
    the generated blobs along the frame's camera rays that hit them first
    (the meshes of more than 1,000 triangles), and their median distance."""
    import torch

    from pbrt_torch.accel.intersect import intersect
    from pbrt_torch.media import volumes as vol_mod

    fc, g = built.film_config, built.scene.geometry
    ys, xs = torch.meshgrid(torch.arange(fc.yres, device=dev), torch.arange(fc.xres, device=dev),
                            indexing="ij")
    half = torch.full((xs.numel(),), 0.5, device=dev)
    rays = built.camera.generate_rays(xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5, half, half, half)
    hit = intersect(g, rays)
    ids, counts = torch.unique(g.tri_mesh_id, return_counts=True)
    blob_ids = ids[counts > 1000]
    tri = (hit.prim >= 0) & (hit.prim < g.num_triangles)
    on_blob = tri & torch.isin(g.tri_mesh_id[hit.prim.clamp(0, g.num_triangles - 1)], blob_ids)
    o, d, t = rays.origin[on_blob], rays.direction[on_blob], hit.t[on_blob]
    tr = vol_mod.transmittance(built.scene.volumes, o, d / d.norm(dim=-1, keepdim=True),
                               torch.zeros_like(t), t * d.norm(dim=-1), torch.full_like(t, 0.5))
    per_bin = tr.mean(0)
    return (float(per_bin.mean()), float(per_bin.min()), float(per_bin.max()),
            float((t * d.norm(dim=-1)).median()), int(on_blob.sum()))


def media_phase(dev, data_dir, drive, profile_frame, card_vs_cpu):
    """Phase 13: killeroo-simple under the halton, bestcandidate, stratified
    and random samplers and the adaptive sampler (both methods), in water
    under single scattering and in an emissive fog under emission; the
    sampler codes and the media block against their plain versions and
    timed; the 16² references. → the kernels line's entries."""
    import torch

    from pbrt_torch.core import rng
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build
    from pbrt_torch.utils import native, timing
    from pbrt_torch.utils.timing import cuda_ms

    sync = torch.cuda.synchronize
    t_phase = time.time()
    text, _ = real_scene_text()
    if KILLEROO_SAMPLER not in text:
        raise SystemExit("killeroo-simple's sampler line is not as written")
    curve = write_water_curve(os.path.join(data_dir, "water_abs.txt"))

    def frame(label, b):
        """A warmed-up, timed 1-spp frame, then one chunk's wave profiled
        and scaled to the frame → (launches, profile)."""
        film, sec, launches, _ = drive(label, b, 1)
        prof = profile_frame(f"{label}, chunk 0", b, sec * 1e3, run=chunk_wave(b, dev),
                             scale=chunks_of(b))
        return film, sec, launches, prof

    # ---- (a) the samplers ----------------------------------------------------
    sampler_launches, kernels = {}, []
    for sampler in PHASE13_SAMPLERS:
        b = build(load_scene_string(text.replace(
            KILLEROO_SAMPLER, f'Sampler "{sampler}" "integer pixelsamples" [8]')), device=dev)
        if b.sampler_name != sampler:
            raise SystemExit(f"the {sampler} scene did not build as written")
        _, _, lk, _ = frame(f"killeroo-simple with the {sampler} sampler", b)
        sampler_launches[sampler] = lk["keyed_uniforms"]
    for method in ("contrast", "shapeid"):
        b = build(load_scene_string(real_scene_text(res=ADAPTIVE_RES)[0].replace(
            KILLEROO_SAMPLER, ADAPTIVE_SAMPLER.format(method))), device=dev)
        # no warm-up render: it is a whole two-pass render (8 waves), and the
        # samplers' frames above warmed the path
        film, sec, lk, _ = drive(f"killeroo-simple with the adaptive sampler ({method})", b, 1,
                                 warm=False)
        a = film.adaptive
        log("render", f"adaptive ({method}, minsamples 2, maxsamples 8): {a['need']} of "
            f"{a['pixels']} pixels supersampled ({100 * a['need'] / a['pixels']:.2f}%), "
            f"{a['waves']} waves, {a['waves'] * a['pixels'] / sec:.1f} camera paths/s traced, "
            f"{(2 * a['pixels'] + 6 * a['need']) / sec:.1f} weighted; weight range "
            f"[{float(film.weight.min()):.3f}, {float(film.weight.max()):.3f}]")
        if not 0 < a["need"] < a["pixels"] or a["waves"] != 8:
            raise SystemExit(f"adaptive ({method}) supersampled no pixel or every pixel")
        sampler_launches["adaptive"] = sampler_launches.get("adaptive", 0) + lk["keyed_uniforms"]

    # ---- (b) killeroo-simple in water, single scattering --------------------
    water = build(load_scene_string(media_scene_text(
        text, WATER_VOLUME.replace("@CURVE@", curve), "single")), device=dev)
    vt = water.scene.volumes
    tr_mean, tr_min, tr_max, dist, n_rays = camera_to_blob_transmittance(water, dev)
    log("media", f"water box around killeroo-simple: σa from {os.path.basename(curve)} "
        f"[{float(vt.sigma_a.min()):.5f}, {float(vt.sigma_a.max()):.5f}] per unit, σs "
        f"[{float(vt.sigma_s.min()):.5f}, {float(vt.sigma_s.max()):.5f}], g {float(vt.g[0]):.2f}; "
        f"transmittance camera to killeroo over {n_rays} camera rays (median distance "
        f"{dist:.1f}): mean over bins {tr_mean:.4f}, bins {tr_min:.4f} to {tr_max:.4f}")
    if not 0.2 <= tr_mean <= 0.6:
        raise SystemExit(f"the water's transmittance to the killeroo, {tr_mean:.3f}, is outside "
                         "[0.2, 0.6]")
    film_w, _, lk_w, prof_w = frame("killeroo-simple in water (single scattering)", water)
    # ---- (c) the same box as an emissive fog, emission ----------------------
    fog = build(load_scene_string(media_scene_text(text, FOG_VOLUME, "emission")), device=dev)
    film_f, _, lk_f, prof_f = frame("killeroo-simple in fog with Le (emission)", fog)
    log("media", f"film sums: water {float(film_w.pixels.double().sum()):.6g}, fog "
        f"{float(film_f.pixels.double().sum()):.6g}; launches per chunk water "
        f"{prof_w['per_chunk']:.1f}, fog {prof_f['per_chunk']:.1f}; keyed_volume_uniforms "
        f"launches {lk_w['keyed_volume_uniforms']} and {lk_f['keyed_volume_uniforms']}")

    # ---- the new keyed cases against their plain versions -------------------
    root = rng.root_key(0)
    pix_all = torch.arange(N_LANES, dtype=torch.int64, device=dev)
    pix_wrap = torch.cat([torch.tensor(PIXELS_WRAP, dtype=torch.int64, device=dev), pix_all])
    scr_all = rng.pixel_scrambles(root, pix_all)
    scr_wrap = rng.pixel_scrambles(root, pix_wrap)
    err, n_cases = {}, 0
    for p_, s_ in [(pix_all, scr_all)] + [(pix_wrap[:n].contiguous(), scr_wrap[:n].contiguous())
                                          for n in (1, 7, 4093, CHUNK)]:
        for sample in (0, 3, 2**31 + 1):
            for sampler in PHASE13_SAMPLERS * (p_.numel() != CHUNK):
                for spp in (1, 4) if p_.numel() == N_LANES else (1, 4, 9):
                    cases = ((rng.primary_uniforms, rng.primary_uniforms_plain, RNG_DEPTH),
                             (rng.ao_uniforms, rng.ao_uniforms_plain, AO_TIMED))
                    for fn, plain, count in cases:
                        k = fn(root, p_, s_, sample, count, sampler, spp)
                        pl = plain(root, p_, s_, sample, count, sampler, spp)
                        if not torch.equal(k.view(torch.int32), pl.view(torch.int32)):
                            raise SystemExit(f"{fn.__name__} ({sampler}, spp {spp}) disagrees "
                                             f"with its plain version on {p_.numel()} lanes, "
                                             f"sample {sample}")
                        err[sampler] = max(err.get(sampler, 0.0), float((k - pl).abs().max()))
                        n_cases += 1
            shapes = ((RNG_DEPTH, True), (RNG_DEPTH, False), (1, True), (17, True))
            if p_.numel() < N_LANES:  # wider than one tile (1,500 and 1,100 columns)
                shapes += ((0, True), (1500, False), (1004, True))
            for n_j, single in shapes:
                k = rng.volume_uniforms(root, p_, sample, n_j, single)
                pl = rng.volume_uniforms_plain(root, p_, sample, n_j, single)
                if not torch.equal(k.view(torch.int32), pl.view(torch.int32)):
                    raise SystemExit(f"keyed_volume_uniforms ({n_j} jitters, single {single}) "
                                     f"disagrees with its plain version on {p_.numel()} lanes, "
                                     f"sample {sample}")
                key = "volume" if single else "volume_emission"
                err[key] = max(err.get(key, 0.0), float((k - pl).abs().max()))
                n_cases += 1
    sync()
    log("rng", f"sampler codes (keyed_uniforms at depth {RNG_DEPTH}, keyed_ao_uniforms at "
        f"{AO_TIMED} AO samples; halton, bestcandidate, stratified, random at spp 1, 4 (and 9 "
        f"on the ragged sets)) and keyed_volume_uniforms (5 jitters with and without single "
        f"scattering's 96 columns, 1 and 17 with them; on the smaller sets also 0 with them, "
        f"1,500 without and 1,004 with, rows of several tiles) vs plain: {n_cases} cases on "
        f"{N_LANES} lanes and 1, 7, 4,093 lanes with pixel indices up to 2**32 - 1 (the "
        f"volume block also on {CHUNK}), samples 0, 3, 2**31 + 1: equal bit for bit")

    # ---- timed at the main path's width -------------------------------------
    pix_c, scr_c = pix_all[:CHUNK].contiguous(), scr_all[:CHUNK].contiguous()
    n_u = 7 * RNG_DEPTH
    per_lane = {  # (bytes, f32 ops, i32 ops) of the camera columns
        "halton": (48, 5 * 4, 5 * 3),
        "bestcandidate": (48, 2 * 4 + OPS_CAMERA_F32 - 6, 2 * 3 + 3),
        "stratified": (0, 5 + 4, OPS_VOLUME_KEY + 5 * OPS_PER_UNIFORM),
        "random": (0, 5, OPS_VOLUME_KEY + 5 * OPS_PER_UNIFORM),
    }
    spread = lambda t: f"{t['min']:.5f}–{t['max']:.5f}"
    for sampler in PHASE13_SAMPLERS:
        tq = timing.queued_rounds(
            lambda: rng.primary_uniforms(root, pix_c, scr_c, 1, RNG_DEPTH, sampler, 1), RNG_ROUNDS)
        plain = cuda_ms(lambda: rng.primary_uniforms_plain(root, pix_c, scr_c, 1, RNG_DEPTH,
                                                           sampler, 1), n=5, warm=1)
        nb, f32, i32 = per_lane[sampler]
        bound, by = timing.bound_ms(CHUNK * (8 + nb + 4 * (5 + n_u)), f32_ops=CHUNK * (n_u + f32),
                                    i32_ops=CHUNK * (OPS_LANE_KEY + n_u * OPS_PER_UNIFORM + i32))
        log("timing", f"keyed_uniforms ({sampler}) on {CHUNK} lanes, depth {RNG_DEPTH}: median "
            f"{tq['ms']:.5f} ms over {RNG_ROUNDS} rounds ({spread(tq)}; plain {plain:.3f} ms, "
            f"host enqueue {tq['host_ms']:.4f} ms); bound {bound:.5f} ms ({by}), kernel / bound "
            f"{tq['ms'] / bound:.2f}x")
        kernels.append(dict(
            name=f"keyed_uniforms[{sampler}]", route="cuda", source="pbrt_torch/csrc/rng.cu",
            replaces=SAMPLER_REPLACES[sampler], launches=sampler_launches[sampler],
            max_abs_err=err[sampler], ms=tq["ms"], plain_ms=plain, bound_ms=bound, bound_by=by,
            library_ms=None))
    lib = native.kernel_lib("rng.cu")
    for key, single, launches, rep in (
            ("keyed_volume_uniforms", True, lk_w["keyed_volume_uniforms"],
             "pbrt_tpu/media/volumes.py:190"),
            ("keyed_volume_uniforms[emission]", False, lk_f["keyed_volume_uniforms"],
             "pbrt_tpu/integrators/path.py:228")):
        plain = cuda_ms(lambda: rng.volume_uniforms_plain(root, pix_c, 1, RNG_DEPTH, single),
                        n=5, warm=1)
        width = RNG_DEPTH + 96 * single
        bound = timing.bound_ms(
            CHUNK * (8 + 4 * width), f32_ops=CHUNK * width,
            i32_ops=CHUNK * (OPS_AO_LANE_KEY + RNG_DEPTH * OPS_PER_JITTER
                             + single * (OPS_VOLUME_KEY + 32 * OPS_PER_STEP)))
        tq = keyed_tile_timed(
            f"{key} on {CHUNK} lanes, {width} columns (plain {plain:.3f} ms)",
            lambda: rng.volume_uniforms(root, pix_c, 1, RNG_DEPTH, single), lib,
            "keyed_volume_uniforms_kernel",
            rng.volume_tiling(CHUNK, RNG_DEPTH, single, rng.sm_count(dev)),
            CHUNK * width, keyed_key_hashes(CHUNK, "volume", n_jitter=RNG_DEPTH, single=single),
            bound, RNG_ROUNDS, fused=True)
        kernels.append(dict(
            name=key, route="cuda", source="pbrt_torch/csrc/rng.cu", replaces=rep,
            launches=launches, max_abs_err=err["volume" if single else "volume_emission"],
            ms=tq["ms"], plain_ms=plain, bound_ms=bound[0], bound_by=bound[1], library_ms=None))

    # ---- 16² references -----------------------------------------------------
    tiny = TINY_SCENE.replace('"path" "integer maxdepth" [5]',
                              '"directlighting" "integer maxdepth" [2]')
    line = 'Sampler "lowdiscrepancy" "integer pixelsamples" [1]'
    for sampler in PHASE13_SAMPLERS + ("adaptive",):
        extra = ' "integer minsamples" [2] "integer maxsamples" [4]' if sampler == "adaptive" else ""
        spp = 4 if sampler in ("stratified", "adaptive") else 2  # a 2 × 2 grid; 2 → 4
        card_vs_cpu(f"tiny scene, {sampler} sampler", tiny.replace(
            line, f'Sampler "{sampler}" "integer pixelsamples" [{spp}]{extra}'), spp=spp,
            chunk_pixels=256, waves=REF_WAVES_SAMPLERS, bin_tol=REF_BIN_REL_CAMERAS)
    for kind, volume in REF_VOLUMES.items():
        for integrator in ("emission", "single"):
            card_vs_cpu(f"tiny scene in a {kind} volume, {integrator}", media_scene_text(
                tiny, volume.replace("@CURVE@", curve), integrator), spp=1, chunk_pixels=256,
                waves=REF_WAVES_SINGLE if integrator == "single" else REF_WAVES_EMISSION,
                bin_tol=REF_BIN_REL_CAMERAS)
    log("media", f"phase 13 took {time.time() - t_phase:.1f} s")
    return kernels


# ---------------------------------------------------------------------------
# phase 14: accelerators, refined shapes and goldens/bunny.pbrt
# ---------------------------------------------------------------------------

#: per-lane bytes of a kd / grid walk: o, d, inv in, tmin and tmax in, the
#: hit (t, prim, b1, b2) out; a motion walk also reads the lane's weight
LANE_BYTES_KD = 36 + 8 + 16
LANE_BYTES_KD_MOTION = LANE_BYTES_KD + 4
#: bytes of a distinct table entry a walk reads: a kd node (split, axis,
#: above child, CSR offset and count), a voxel (CSR offset and count), a
#: CSR id, a packed triangle (its shutter-end deltas as many again under
#: motion), a quadric (type, the 12 used floats of w2o, 8 parameters)
KD_NODE_BYTES, VOXEL_BYTES, CSR_BYTES = 5 * 4, 2 * 4, 4
TRI_ROW_BYTES, QUAD_ROW_BYTES = 9 * 4, (1 + 12 + 8) * 4
WORLD_BOX_BYTES = 6 * 4
#: float operations, counted from csrc/traverse_kd.cu: the world-box clip
#: (6 subtractions and products, 6 min / max, 4 more), a kd interior node
#: (the plane's t, 2; 6 comparisons), a voxel step (argmin 2, the step's
#: compares and add 4, the vid 2 integer ops counted alike), a triangle test
#: (Möller–Trumbore: 27 products, 20 sums, the reciprocal, 6 comparisons),
#: the lerp of its 9 floats (9 products, 9 sums), a quadric test (the
#: object ray 30, the quadratic ~16, two roots' clip tests with their
#: atan2 (~20 each) and points 6 each, u and v ~28: ~126), a pop (2)
OPS_KD_LANE, OPS_KD_NODE, OPS_VOXEL_STEP = 16, 8, 8
OPS_TRI_TEST, OPS_TRI_LERP, OPS_QUAD_TEST, OPS_KD_POP = 54, 18, 126, 2
#: lanes of the frame's rays the new kernels are held against their plain
#: versions on, and of the motion scene's (phase 11's, as written)
ACCEL_LANES, ACCEL_MOTION_LANES = 1 << 18, 1 << 16
#: calls per timing round: a static kd walk takes ~0.1 ms, a grid walk ~1
#: ms, a motion walk 2.5–6 ms (32 lanes per ray on an H100)
TIMING_CALLS = {"kdtree": 50, "grid": 20, "motion": 5}
#: aggregatetest's rays on killeroo (the brute-force oracle holds an
#: (R, 2048, 3) block per field: 2**14 rays keep it to 0.4 GB)
AGGREGATE_RAYS = 1 << 14
#: the bunny's stand-in control mesh: a blob of 20·4² = 320 faces, Loop
#: subdivided 3 times as bunny.pbrt's include asks (20,480 faces)
BUNNY_FREQ, BUNNY_RADIUS = 4, 0.07
#: the refined-shapes room: a 256 × 256 heightfield floor
ROOM_HEIGHTFIELD = 256
REFINED_NURBS = (
    '"integer nu" [5] "integer uorder" [4] "float uknots" [0 0 0 0 .5 1 1 1 1] '
    '"integer nv" [4] "integer vorder" [3] "float vknots" [0 0 0 .4 1 1 1] '
    '"float u0" [.1] "float u1" [.9] "point P" [@P@]')


#: the tie-and-dense scene (``tie_scene_text``): its copies of one triangle,
#: its cluster, its far soup (which gives the kd-tree interior nodes and
#: brings the prims to 1,200, so the grid is 32³ voxels of width 1/2 over
#: its 16³ world box) and the kd-tree's leaf size that keeps the copies,
#: the cluster and the sphere in one leaf
TIE_COPIES, TIE_CLUSTER, TIE_SOUP, TIE_MAXPRIMS = 70, 100, 1027, 256
#: the plane of the copies, the cluster's planes a few ulps about it, the
#: sphere (centre, radius) below the plane beside the copies, all in the
#: grid's voxel [0, 1/2]² × [4, 4.5]
TIE_Z, TIE_SPHERE = 4.25, ((0.3125, 0.3125, 4.125), 0.03125)


def _exact(v) -> str:
    """A float32 written so the scene parser reads it back bit for bit."""
    return repr(float(np.float32(v)))


def tie_scene_text(acc: str, motion: bool = False) -> str:
    """The tie-and-dense scene under ``acc``: prims 0..69 are exact copies
    of one triangle (equal t, b1 and b2: three chunks of 32 lanes, nine of
    8); prims 70..169 a cluster of small triangles in planes z = TIE_Z + m
    ulps, m in -3..3 (t a few ulps apart, and tied within a plane); then a
    sphere in the same kd leaf and grid voxel; a soup far off and two
    corner triangles that fix the world box at [-8, 8]³. Every coordinate is
    dyadic and every edge axis-aligned, so a hit's t (= the plane's z minus
    the origin's) is exact in any order of operations, FMA or not. With
    ``motion`` the copies and the cluster move by 1/32 along z over the
    shutter (the soup and the sphere stand still)."""
    ulp = float(np.spacing(np.float32(TIE_Z)))
    rng = np.random.default_rng(17)
    tri = lambda v0, a, b: [v0, (v0[0] + a, v0[1], v0[2]), (v0[0], v0[1] + b, v0[2])]
    moving = [tri((0.0, 0.0, TIE_Z), 0.4375, 0.4375)] * TIE_COPIES
    for j in range(TIE_CLUSTER):
        x0 = 0.0625 + (j % 10) * 2.0 ** -7
        y0 = 0.0625 + (j // 10) * 2.0 ** -7
        moving.append(tri((x0, y0, TIE_Z + ((j * 37) % 7 - 3) * ulp), 0.0625, 0.0625))
    soup = [tri((-8.0, -8.0, -8.0), 0.5, 0.5), tri((7.5, 7.5, 8.0), 0.5, 0.5)]
    for _ in range(TIE_SOUP):
        v0 = rng.integers(-112, -48, 3) / 16.0
        v0[1:] += rng.integers(0, 112, 2) / 16.0
        ts = [tuple(v0), tuple(v0 + rng.integers(-8, 9, 3) / 16.0),
              tuple(v0 + rng.integers(-8, 9, 3) / 16.0)]
        soup.append(ts)

    def mesh(tris):
        P = " ".join(_exact(c) for t in tris for v in t for c in v)
        return (f'Shape "trianglemesh" "point P" [{P}] "integer indices" ['
                + " ".join(map(str, range(3 * len(tris)))) + "]\n")

    (cx, cy, cz), r = TIE_SPHERE
    head = ("AttributeBegin\n  ActiveTransform EndTime\n  Translate 0 0 0.03125\n"
            "  ActiveTransform All\n" if motion else "AttributeBegin\n")
    return f"""
LookAt 0 0 -2  0 0 4  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Accelerator "{acc}" {'"integer maxprims" [%d]' % TIE_MAXPRIMS if acc == "kdtree" else ""}
WorldBegin
{head}{mesh(moving)}AttributeEnd
AttributeBegin
  Translate {cx} {cy} {cz}
  Shape "sphere" "float radius" [{r}]
AttributeEnd
{mesh(soup)}WorldEnd
"""


def tie_rays(n: int, seed: int = 0):
    """(o, d, time) float32 numpy rays over the tie scene's copies,
    cluster and sphere: half along ±z from below and above, the rest
    tilted by powers of two (their products with a dyadic coordinate are
    exact) and kept off the sphere (whose quadratic they would round); the
    origins on odd multiples of 2^-10, off every edge and split plane;
    ray times on a 1/16 grid."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3))
    d = np.zeros((n, 3))
    down = rng.uniform(size=n) < 0.5
    o[:, 2] = np.where(down, 7.5, 0.5)
    d[:, 2] = np.where(down, -1.0, 1.0)
    tilt = rng.uniform(size=n) < 0.5
    k = rng.integers(0, np.where(tilt, 96, 160)[:, None], (n, 2))  # tilted: x, y < 0.25
    o[:, :2] = 0.03125 + (2 * k + 1) * 2.0 ** -10
    sgn = rng.choice([-1.0, 1.0], (n, 2))
    d[:, :2] = np.where(tilt[:, None], sgn * 2.0 ** -rng.integers(7, 11, (n, 2)), 0.0)
    time_ = rng.integers(0, 17, n) / 16.0
    return o.astype(np.float32), d.astype(np.float32), time_.astype(np.float32)


#: the instanced tie scene's object: the box [0, 1]² × [0, 1/2], 12
#: triangles, every edge axis-aligned
INSTANCE_TIE_BOX = ("0 0 0  1 0 0  1 1 0  0 1 0  0 0 0.5  1 0 0.5  1 1 0.5  0 1 0.5",
                    "0 2 1  0 3 2  4 5 6  4 6 7  0 1 5  0 5 4  1 2 6  1 6 5  2 3 7  2 7 6  "
                    "3 0 4  3 4 7")


def instance_tie_scene_text() -> str:
    """The instanced tie scene: one box (``INSTANCE_TIE_BOX``) used three
    times, uses 0 and 1 at the same transform (z + 2) and use 2 turned a
    quarter about z about the footprint's centre (an exact matrix), so all
    three fill [0, 1]² × [2, 2.5]; and a world triangle coincident with half
    of their bottom face (z = 2). Every coordinate and matrix entry is
    dyadic and every edge axis-aligned, so a hit's t is exact in any order
    of operations, FMA or not: rays along z reach the same t in every use
    (and in the world triangle from below), each use's walk ties the last,
    and the serial order and the strict t < t_best decide (t, prim, b1, b2)
    and inst."""
    P, idx = INSTANCE_TIE_BOX
    same = "AttributeBegin\n  Translate 0 0 2\n  ObjectInstance \"box\"\nAttributeEnd\n"
    return f"""
LookAt 0.5 0.5 -4  0.5 0.5 2  0 1 0
Camera "perspective" "float fov" [30]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "distant" "rgb L" [3 3 3] "point from" [1 2 -4] "point to" [0.5 0.5 2]
Material "matte" "rgb Kd" [.5 .5 .5]
ObjectBegin "box"
Shape "trianglemesh" "point P" [{P}] "integer indices" [{idx}]
ObjectEnd
{same}{same}AttributeBegin
  Translate 0.5 0.5 2
  ConcatTransform [0 1 0 0  -1 0 0 0  0 0 1 0  0 0 0 1]
  Translate -0.5 -0.5 0
  ObjectInstance "box"
AttributeEnd
Shape "trianglemesh" "point P" [0 0 2  1 0 2  0 1 2] "integer indices" [0 1 2]
Shape "trianglemesh" "point P" [-4 -4 -4  -3.5 -4 -4  -4 -3.5 -4] "integer indices" [0 1 2]
WorldEnd
"""


def instance_tie_rays(n: int, seed: int = 0):
    """(o, d) float32 numpy rays over the instanced tie scene's footprint:
    half along +z from z = 1/2 (they reach the bottom face, z = 2, at t =
    3/2), half along -z from z = 15/2 (the top face at t = 5); half of each
    tilted in x and y by powers of two (exact products); the origins on odd
    multiples of 2^-10 in [1/32, 31/32]², off the footprint's sides (one on
    a face's diagonal meets both its triangles at the same t: one more
    tie)."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3))
    d = np.zeros((n, 3))
    up = rng.uniform(size=n) < 0.5
    o[:, 2] = np.where(up, 0.5, 7.5)
    d[:, 2] = np.where(up, 1.0, -1.0)
    o[:, :2] = 0.03125 + (2 * rng.integers(0, 480, (n, 2)) + 1) * 2.0 ** -10
    tilt = rng.uniform(size=n) < 0.5
    sgn = rng.choice([-1.0, 1.0], (n, 2))
    d[:, :2] = np.where(tilt[:, None], sgn * 2.0 ** -rng.integers(5, 11, (n, 2)), 0.0)
    return o.astype(np.float32), d.astype(np.float32)


def instance_tie_kernels_equal_plain(dev, n: int = 4096, seed: int = 3) -> dict:
    """The instanced tie scene on ``dev``: the world walk, then both
    instance kernels held to the plain phase on ``n`` of
    ``instance_tie_rays``, closest hit and any hit on segments cut 2^-20
    past the closest hit (even lanes) or at half of it (odd lanes). →
    equal (per kernel key, t, prim, b1, b2, inst bit for bit), the closest
    hits, how many use 0 and the world triangle hold, and the occluded."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    g = build(load_scene_string(instance_tie_scene_text()), device=dev).scene.geometry
    o, d = (torch.as_tensor(x, device=dev) for x in instance_tie_rays(n, seed))
    inv = isect.make_inv_dir(d).contiguous()
    tmin = torch.zeros(n, device=dev)
    tmax = torch.full((n,), float("inf"), device=dev)
    itab = (g.inst_rows, g.inst_stack, g.inst_w2o, g.inst_lo, g.inst_hi, g.inst_root)
    bits = lambda k, p: all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                            for a, b in zip(k, p))
    equal, res = {}, {}
    for key, any_hit in (("traverse_instances_closest", False), ("traverse_instances_any", True)):
        if any_hit:
            t_c = res["traverse_instances_closest"][0]
            lane = torch.arange(n, device=dev)
            tmax = torch.where(torch.isfinite(t_c), torch.where(lane % 2 == 0, t_c + 2.0 ** -20,
                                                                t_c * 0.5), 1e30).contiguous()
        world = tc.traverse(g.wide_rows, g.wide_stack, o, d, inv, tmin, tmax,
                            *walk_seeds(g, o, d, tmin, tmax), any_hit=any_hit)
        args = (*itab, o, d, inv, tmin, tmax, *world)
        res[key] = tc.traverse_instances(*args, any_hit=any_hit)
        equal[key] = bits(res[key], tc.traverse_instances_plain(*args, any_hit))
    c = res["traverse_instances_closest"]
    hit = c[1] >= 0
    return dict(equal=equal, hits=int(hit.sum()), use0=int((c[4] == 0).sum()),
                world=int((hit & (c[4] == -1)).sum()),
                occluded=int((res["traverse_instances_any"][1] >= 0).sum()))


def tie_kernels_equal_plain(dev, acc: str, n: int = 4096, seed: int = 2) -> dict:
    """The tie-and-dense scene (with motion) under ``acc`` on ``dev``, its
    walk's four kernels held to their plain versions on ``n`` of
    ``tie_rays``: the static ones on the start rows, the motion ones
    lerped; any hit on segments that end 2^-20 past the closest hit (the
    ties kept) or 1 past it. → {kernel key: t, prim, b1, b2 equal bit for
    bit}, and under "hits" the closest hits on the copies (all on copy 0
    where equal), the cluster and the sphere."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_kd as tk
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    g = build(load_scene_string(tie_scene_text(acc, motion=True)), device=dev).scene.geometry
    o, d, tm = (torch.as_tensor(x, device=dev) for x in tie_rays(n, seed))
    inv = isect.make_inv_dir(d).contiguous()
    tmin = torch.zeros(n, device=dev)
    tmax = torch.full((n,), float("inf"), device=dev)
    tw = isect.motion_weight(g, tm).contiguous()
    walk, plain = ((tk.traverse_kd, tk.traverse_kd_plain) if acc == "kdtree"
                   else (tk.traverse_grid, tk.traverse_grid_plain))
    short = "kd" if acc == "kdtree" else "grid"
    out = {}
    for w, m in ((None, ""), (tw, "_motion")):
        pc = plain(g, o, d, inv, tmin, tmax, False, w)
        past = torch.where(torch.arange(n, device=dev) % 2 == 0, 2.0 ** -20, 1.0)
        tmax_a = torch.where(torch.isfinite(pc[0]), pc[0] + past, 1e30).contiguous()
        for side, any_hit, tmx in (("closest", False, tmax), ("any", True, tmax_a)):
            k = walk(g, o, d, inv, tmin, tmx, any_hit, w)
            p = pc if side == "closest" else plain(g, o, d, inv, tmin, tmx, any_hit, w)
            out[f"traverse_{short}_{side}{m}"] = all(
                torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(k, p))
        prim = pc[1]
        out.setdefault("hits", {})["motion" if m else "static"] = dict(
            copies=int(((prim >= 0) & (prim < TIE_COPIES)).sum()),
            copy0=int((prim == 0).sum()),
            cluster=int(((prim >= TIE_COPIES) & (prim < TIE_COPIES + TIE_CLUSTER)).sum()),
            sphere=int((prim == g.num_triangles).sum()))
    return out


def tie_bvh_motion_equal_plain(dev, n: int = 4096, seed: int = 2) -> dict:
    """The tie-and-dense scene with motion under the BVH on ``dev``: the
    two motion kernels (culling by the time boxes) held to the union plain
    walk on ``n`` of ``tie_rays``, closest hit and any hit on segments that
    end 2^-20 past the closest hit or 1 past it, each seeded with the
    quadric pass as ``intersect`` seeds them. → {kernel key: t, prim, b1,
    b2 equal bit for bit}, and under "hits" the closest hits on the
    copies, the cluster and the sphere."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    g = build(load_scene_string(tie_scene_text("bvh", motion=True)), device=dev).scene.geometry
    o, d, tm = (torch.as_tensor(x, device=dev) for x in tie_rays(n, seed))
    inv = isect.make_inv_dir(d).contiguous()
    tmin = torch.zeros(n, device=dev)
    tmax = torch.full((n,), float("inf"), device=dev)
    mt = dict(motion_rows=g.wide_motion, tw=isect.motion_weight(g, tm).contiguous())
    tab = (g.wide_rows, g.wide_stack, o, d, inv, tmin)
    seeds = lambda tmx: [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmx)]
    pc = tc.traverse_plain(*tab, tmax, *seeds(tmax), False, **mt)
    past = torch.where(torch.arange(n, device=dev) % 2 == 0, 2.0 ** -20, 1.0)
    tmax_a = torch.where(torch.isfinite(pc[0]), pc[0] + past, 1e30).contiguous()
    out = {}
    for side, any_hit, tmx in (("closest", False, tmax), ("any", True, tmax_a)):
        s_ = seeds(tmx)
        k = tc.traverse(*tab, tmx, *s_, any_hit, time_boxes=g.wide_tbox, **mt)
        p = pc if not any_hit else tc.traverse_plain(*tab, tmx, *s_, any_hit, **mt)
        out[f"traverse_{side}_motion"] = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(k, p))
    prim = pc[1]
    out["hits"] = dict(
        copies=int(((prim >= 0) & (prim < TIE_COPIES)).sum()),
        cluster=int(((prim >= TIE_COPIES) & (prim < TIE_COPIES + TIE_CLUSTER)).sum()),
        sphere=int((prim == g.num_triangles).sum()))
    return out


def bunny_control_mesh(radius: float = BUNNY_RADIUS, freq: int = BUNNY_FREQ):
    """A coarse blob standing on z = 0: (P, idx), the control mesh of the
    loop-subdivided stand-ins."""
    return blob_mesh(freq, radius=radius, seed=19)


def loopsubdiv_text(P, idx, nlevels: int = 3) -> str:
    return (f'Shape "loopsubdiv" "integer nlevels" [{nlevels}] "point P" ['
            + " ".join(f"{v:.6g}" for v in P.ravel()) + ']\n  "integer indices" ['
            + " ".join(map(str, idx.ravel())) + "]\n")


def nurbs_text() -> str:
    """A cubic 5 × 4 NURBS patch over [0, 1]², bulging up to .3."""
    xs, ys = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 1, 4))
    z = 0.3 * np.sin(np.pi * xs) * np.sin(np.pi * ys)
    P = np.stack([xs, ys, z], -1).ravel()
    return 'Shape "nurbs" ' + REFINED_NURBS.replace("@P@", " ".join(f"{v:.6g}" for v in P))


def write_bunny_data(directory: str):
    """``goldens/bunny.pbrt``'s two files, generated: ``geometry/bunny.pbrt``
    (the loop-subdivided stand-in, standing on y = 0 about the origin) and
    ``brdfs/mystique.brdf`` (phase 9's measured-file stand-in)."""
    P, idx = bunny_control_mesh()
    P = np.stack([P[:, 0], P[:, 2], -P[:, 1]], -1)  # stand on y = 0 (a rotation)
    for sub in ("geometry", "brdfs", "materials"):
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
    with open(os.path.join(directory, "geometry", "bunny.pbrt"), "w") as f:
        f.write(loopsubdiv_text(P, idx))
    write_material_data(os.path.join(directory, "materials"))
    shutil.copy(os.path.join(directory, "materials", "generated.brdf"),
                os.path.join(directory, "brdfs", "mystique.brdf"))


def bunny_scene(directory: str, res: int | None = None) -> str:
    """``goldens/bunny.pbrt`` as written, into ``directory`` beside its
    generated files (at res × res if given); → its path."""
    with open(os.path.join(HERE, "goldens", "bunny.pbrt")) as f:
        text = f.read()
    if res is not None:
        text = text.replace('"integer xresolution" [256] "integer yresolution" [256]',
                            f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    path = os.path.join(directory, f"bunny{res or ''}.pbrt")
    with open(path, "w") as f:
        f.write(text)
    return path


def refined_room_text(res: int = 512, hf: int = ROOM_HEIGHTFIELD,
                      shapes=("heightfield", "loopsubdiv", "nurbs"), depth: int = 5) -> str:
    """killeroo-simple's room (``path``) with its floor a hf × hf
    heightfield, the first blob the loop-subdivided stand-in and the
    second a NURBS patch standing up (each kept only if named in
    ``shapes``; the floor is the written quad otherwise)."""
    text = KILLEROO_SIMPLE.replace(
        'SurfaceIntegrator "directlighting"',
        f'SurfaceIntegrator "path" "integer maxdepth" [{depth}]').replace(
        '"integer xresolution" [512] "integer yresolution" [512]',
        f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    floor = ('Shape "trianglemesh" "point P" [ -1000 -1000 0 1000 -1000 0 1000 1000 0 '
             '-1000 1000 0 ]\n      "float uv" [ 0 0 5 0 5 5 0 5 ]\n\t"integer indices" [ 0 1 2 2 3 0]')
    if floor not in text:
        raise ValueError("killeroo-simple's floor is not as written")
    if "heightfield" in shapes:
        yy, xx = np.mgrid[0:hf, 0:hf] / max(hf - 1, 1)
        z = 0.5 + 0.5 * np.sin(11 * xx) * np.cos(7 * yy)
        text = text.replace(floor, (
            "AttributeBegin\n  Translate -1000 -1000 0\n  Scale 2000 2000 12\n"
            f'  Shape "heightfield" "integer nu" [{hf}] "integer nv" [{hf}] "float Pz" ['
            + " ".join(f"{v:.4g}" for v in z.ravel()) + "]\nAttributeEnd"))
    P, idx = bunny_control_mesh(radius=60.0)
    first = loopsubdiv_text(P, idx) if "loopsubdiv" in shapes else ""
    second = ("AttributeBegin\n  Translate -60 0 0\n  Rotate 90 1 0 0\n  Scale 140 140 140\n  "
              + nurbs_text() + "\nAttributeEnd\n") if "nurbs" in shapes else ""
    head, tail = text.split("@MESH@", 1)
    return head + first + tail.replace("@MESH@", second, 1)


def accel_scene_text(text: str, acc: str) -> str:
    """A scene's text with ``Accelerator "acc"`` before its WorldBegin."""
    return text.replace("WorldBegin", f'Accelerator "{acc}"\nWorldBegin', 1)


def kd_ray_sets(b, dev, motion: bool) -> dict:
    """Phase 14's rays of a built scene under the kd-tree or the grid, as
    its checks and timings and ``scripts/kd_grid_lab.py`` take them:
    killeroo-simple's ``ACCEL_LANES`` camera and bounce rays (seed 21), or,
    with ``motion``, the motion scene's ``ACCEL_MOTION_LANES`` at their own
    shutter times, permuted (seed 22). → dict of o, d, inv, tmin, tmax, tw
    (None when static), scale (``any_tmax``'s cut of the closest hit), brute
    (the brute-force lanes, static only), timing (the timing set's lanes:
    ``CHUNK`` drawn at random, or the first ``CHUNK`` under motion) and si
    (the camera rays' interactions)."""
    import torch

    from pbrt_torch.accel import intersect as isect

    gen = torch.Generator(device=dev)
    gen.manual_seed(22 if motion else 21)
    o, d, t_ray, _, si = camera_and_bounce_rays(
        b, dev, ACCEL_MOTION_LANES if motion else ACCEL_LANES, gen, times=motion)
    R = o.shape[0]
    tw = brute = None
    if motion:
        perm = torch.randperm(R, generator=gen, device=dev)
        o, d, t_ray = o[perm].contiguous(), d[perm].contiguous(), t_ray[perm]
        tw = isect.motion_weight(b.scene.geometry, t_ray).contiguous()
        scale, timing = 0.75, slice(0, CHUNK)  # any hit below 3/4 of the closest hit
    else:
        # any hit on segments cut at half or 1.5 times the closest hit
        scale = torch.where(torch.rand(R, generator=gen, device=dev) < 0.5, 0.5, 1.5)
        brute = torch.randperm(R, generator=gen, device=dev)[:BRUTE_LANES]
        timing = torch.randperm(R, generator=gen, device=dev)[:CHUNK]
    return dict(o=o, d=d, inv=isect.make_inv_dir(d).contiguous(),
                tmin=torch.zeros(R, device=dev), tmax=torch.full((R,), float("inf"), device=dev),
                tw=tw, scale=scale, brute=brute, timing=timing, si=si)


def any_tmax(closest_t, scale):
    """The any-hit segments' ends: the closest hit's t times ``scale``,
    1e30 where the ray missed."""
    import torch

    return torch.where(torch.isfinite(closest_t), closest_t * scale, 1e30).contiguous()


def accelerators_phase(dev, data_dir, drive, profile_frame, card_vs_cpu, bvh):
    """Phase 14: killeroo-simple under the kd-tree and the grid (their
    frames beside the BVH's of phase 7, ``bvh``), the two kernel families
    against their plain versions and timed, aggregatetest under all three
    accelerators, ``goldens/bunny.pbrt`` as written, the refined-shapes
    room, and the 16² references. → the kernels line's entries."""
    import contextlib
    import io

    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_kd as tk
    from pbrt_torch.core import geometry as geom
    from pbrt_torch.renderers import dispatch
    from pbrt_torch.renderers.sampler import render
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build
    from pbrt_torch.scene.paramset import ParamSet
    from pbrt_torch.utils import native, timing
    from pbrt_torch.utils.timing import cuda_ms

    sync = torch.cuda.synchronize
    t_phase = time.time()
    bits = lambda k, p: all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                            for a, b in zip(k, p))
    # the kernels as built, and the other width's build timed beside them
    kd_lib = native.kernel_lib("traverse_kd.cu")
    other_lib = native.kernel_lib("traverse_kd.cu", defines=tk.VARIANTS["other_width"])

    def design(key, targs, calls, ref):
        """The kernel's G, registers and blocks per SM, and the other width's
        build on the same inputs: held to the plain walk's ``ref`` bit for
        bit, then timed → text."""
        info, oinfo = tk.kernel_info(kd_lib, key), tk.kernel_info(other_lib, key)
        other = lambda: tk.launch_with(other_lib, *targs)
        if not bits(other(), ref):
            raise SystemExit(f"{key} at G = {oinfo['width']} disagrees with its plain version")
        tq = timing.queued_rounds(other, RNG_ROUNDS, calls, warm=1)
        return (f"G {info['width']}, {info['registers']} registers, {info['local_bytes']} local "
                f"bytes, {info['shared_bytes']} shared bytes, {info['blocks_per_sm']} blocks of "
                f"{info['threads']} per SM; at G {oinfo['width']} (equal to plain bit for bit, "
                f"{oinfo['registers']} registers, {oinfo['blocks_per_sm']} blocks per SM) "
                f"{tq['ms']:.4f} ms (median of {RNG_ROUNDS} rounds)")
    text, n_mesh = real_scene_text()
    walks = {"kdtree": (tk.traverse_kd, tk.traverse_kd_plain),
             "grid": (tk.traverse_grid, tk.traverse_grid_plain)}
    short = {"kdtree": "kd", "grid": "grid"}
    entries, frames, built = {}, {}, {}

    # ---- (a) killeroo-simple under each accelerator ------------------------
    for acc in ("kdtree", "grid"):
        t0 = time.time()
        b = build(load_scene_string(accel_scene_text(text, acc)), device=dev)
        build_s = time.time() - t0
        g = b.scene.geometry
        tabs = ([g.kd_split, g.kd_axis, g.kd_above, g.kd_prim_off, g.kd_prim_cnt, g.kd_prim_ids]
                if acc == "kdtree" else [g.grid_off, g.grid_cnt, g.grid_ids])
        size = (f"{g.kd_axis.numel()} nodes ({int((g.kd_axis == 3).sum())} leaves), "
                f"{g.kd_prim_ids.numel()} CSR ids" if acc == "kdtree" else
                f"{'x'.join(map(str, g.grid_dims))} voxels, {g.grid_ids.numel()} CSR ids")
        log("scene", f"killeroo-simple under the {acc}: {g.num_triangles} triangles and "
            f"{g.num_quadrics} sphere in {size}; tables on the device "
            f"{sum(x.numel() * x.element_size() for x in tabs) / 2**20:.2f} MiB (+ "
            f"{g.leaf_prims.tri.numel() * 4 / 2**20:.2f} MiB packed triangles); no wide rows "
            f"{g.wide_rows is None}; built in {build_s:.1f} s (the whole scene, host numpy)")
        if g.accel_kind != acc or g.wide_rows is not None or g.num_triangles != 4 + 2 * n_mesh:
            raise SystemExit(f"killeroo-simple did not build under the {acc}")
        built[acc] = b
        ic = b.integrator
        for kind in ("directlighting", "path"):
            bk = dataclasses.replace(b, integrator=dataclasses.replace(ic, kind=kind))
            _, sec, lk, _ = drive(f"killeroo-simple, {acc}, {kind}", bk, 1, warm=kind == "path")
            if not (lk[f"traverse_{short[acc]}_closest"] and lk[f"traverse_{short[acc]}_any"]):
                raise SystemExit(f"the {acc} frame did not launch its own kernels")
            prof = profile_frame(f"killeroo-simple, {acc}, {kind}", bk, sec * 1e3,
                                 run=chunk_wave(bk, dev), scale=chunks_of(bk))
            frames[(acc, kind)] = dict(sec=sec, launches=lk, **prof)
    for kind in ("directlighting", "path"):
        n_px = 512 * 512
        parts = []
        for acc in ("bvh", "kdtree", "grid"):
            f = bvh[kind] if acc == "bvh" else frames[(acc, kind)]
            parts.append(f"{acc} {f['sec'] * 1e3:.1f} ms ({n_px / f['sec']:.1f} camera paths/s), "
                         f"kernel time {f['ms']:.1f} ms, {f['per_chunk']:.1f} launches per chunk")
        log("accel", f"killeroo-simple 512², {kind} depth 5, per 1-spp frame: " + "; ".join(parts)
            + " (bvh: phase 7's frames, its 4-spp render per sample)")

    # ---- (b) the kernels against their plain versions, on the frame's rays
    for acc in ("kdtree", "grid"):
        b = built[acc]
        g = b.scene.geometry
        walk, plain = walks[acc]
        rs = kd_ray_sets(b, dev, motion=False)
        o, d, inv, tmin, tmax, si = (rs[k] for k in ("o", "d", "inv", "tmin", "tmax", "si"))
        R = o.shape[0]
        kc = walk(g, o, d, inv, tmin, tmax, False)
        pc = plain(g, o, d, inv, tmin, tmax, False)
        tmax_a = any_tmax(pc[0], rs["scale"])
        ka = walk(g, o, d, inv, tmin, tmax_a, True)
        pa = plain(g, o, d, inv, tmin, tmax_a, True)
        ragged = True
        for n in (1, 7, 4093):
            for any_hit, tm in ((False, tmax), (True, tmax_a)):
                cut = [x[:n].contiguous() for x in (o, d, inv, tmin, tm)]
                ragged &= bits(walk(g, *cut, any_hit), plain(g, *cut, any_hit))
        sync()
        eq = {"closest": bits(kc, pc), "any": bits(ka, pa)}
        fin, fa = torch.isfinite(pc[0]), pa[1] >= 0
        errs = {"closest": float((kc[0][fin] - pc[0][fin]).abs().max()) if fin.any() else 0.0,
                "any": float((ka[0][fa] - pa[0][fa]).abs().max()) if fa.any() else 0.0}
        # brute force as phase 3 holds the BVH kernel to it, but rtol 1e-5:
        # its unpacked Möller–Trumbore sums by torch's reductions, and on
        # bounce rays t = (e2 · q) / det cancels (1.56e-6 seen on the kd-tree)
        sel = rs["brute"]
        hb = isect.intersect_brute(g, geom.Ray.make(o[sel], d[sel]))
        sync()
        kv, bv = kc[1][sel] >= 0, hb.prim >= 0
        v = kv & bv
        rel = float(((kc[0][sel][v] - hb.t[v]).abs() / hb.t[v].abs()).max()) if v.any() else 0.0
        prim_eq = float((kc[1][sel] == hb.prim).float().mean())
        brute_ok = bool(torch.equal(kv, bv)) and rel <= 1e-5 and prim_eq >= 0.999
        log("kernels", f"{acc} kernels vs plain on {R} rays of killeroo-simple ({R // 2} camera "
            f"rays, {R - R // 2} bounce rays from {int(si.valid.sum())} first hits): t, prim, "
            f"b1, b2 equal bit for bit {eq}; on 1, 7 and 4093 lanes {ragged}; closest hits "
            f"{int((pc[1] >= 0).sum())}, occluded {int(fa.sum())}; closest hit vs "
            f"intersect_brute on {BRUTE_LANES} lanes: valid equal {bool(torch.equal(kv, bv))}, "
            f"max rel t diff {rel:.3g}, prim equal on {prim_eq:.6f} of lanes (rtol 1e-5 on t; "
            f"prims may differ only on exact-t ties)")
        if not (all(eq.values()) and ragged and brute_ok):
            raise SystemExit(f"a {acc} kernel disagrees with its plain version or brute force")
        t0 = time.time()
        tie = tie_kernels_equal_plain(dev, acc)
        tie_hits = tie.pop("hits")
        log("kernels", f"{acc} kernels vs plain on the tie-and-dense scene (4096 rays; "
            f"{TIE_COPIES} copies of one triangle, a cluster of {TIE_CLUSTER} in planes a few "
            f"ulps apart and a sphere in one leaf or voxel): t, prim, b1, b2 equal bit for bit "
            f"{tie}; closest hits {tie_hits} ({time.time() - t0:.1f} s)")
        if not (all(tie.values()) and all(h["copies"] == h["copy0"] for h in tie_hits.values())):
            raise SystemExit(f"a {acc} kernel disagrees with its plain version on the tie scene")
        # timed at the main path's launch width, with the plain version's work
        sub = rs["timing"]
        pick = lambda x: x[sub].contiguous()
        for side, any_hit, tm in (("closest", False, tmax), ("any", True, tmax_a)):
            key = f"traverse_{short[acc]}_{side}"
            targs = (g, pick(o), pick(d), pick(inv), pick(tmin), pick(tm), any_hit)
            stats = {}
            plain_ms = cuda_ms(lambda: plain(*targs, stats=stats), n=1, warm=0)
            tq = timing.queued_rounds(lambda: walk(*targs), RNG_ROUNDS, TIMING_CALLS[acc],
                                      warm=1)
            nbytes, ops = kd_work(acc, stats, CHUNK, motion=False)
            b_ms, b_by = timing.bound_ms(nbytes, f32_ops=ops)
            entries[key] = dict(max_abs_err=errs[side], ms=tq["ms"], plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by)
            summ = step_summary(stats["lane_steps"], tq["ms"])
            what = design(key, targs, TIMING_CALLS[acc],
                          [x[sub] for x in (pc if side == "closest" else pa)])
            log("timing", f"{key}, permuted set of killeroo-simple, {CHUNK} lanes: median "
                f"{tq['ms']:.4f} ms over {RNG_ROUNDS} rounds of {TIMING_CALLS[acc]} calls "
                f"({tq['min']:.4f}–{tq['max']:.4f}; "
                f"plain {plain_ms:.1f} ms with its counting, host enqueue {tq['host_ms']:.4f} ms); "
                f"{work_text(acc, stats)}, {nbytes} bytes, {ops} operations; bound {b_ms:.5f} ms "
                f"({b_by}), kernel / bound {tq['ms'] / b_ms:.1f}x; passes per lane mean "
                f"{summ['mean']:.2f}, max {summ['max']}; {what}")
        del kc, pc, ka, pa, o, d, inv, si, rs
        torch.cuda.empty_cache()

    # the motion scene under each accelerator: its frame (the motion
    # kernels' launches) and its rays
    for acc in ("kdtree", "grid"):
        walk, plain = walks[acc]
        t0 = time.time()
        b = build(load_scene_string(accel_scene_text(anim_scene_text(), acc)), device=dev)
        g = b.scene.geometry
        log("scene", f"anim-killeroos-moving under the {acc}: {g.num_triangles} triangles "
            f"(moving), " + (f"{g.kd_axis.numel()} nodes, {g.kd_prim_ids.numel()} CSR ids"
                             if acc == "kdtree" else f"{'x'.join(map(str, g.grid_dims))} "
                             f"voxels, {g.grid_ids.numel()} CSR ids")
            + f"; built in {time.time() - t0:.1f} s")
        if not (g.has_motion and g.accel_kind == acc and g.num_triangles == 4 + 2 * n_mesh):
            raise SystemExit(f"the motion scene did not build under the {acc}")
        _, sec, lk, _ = drive(f"anim-killeroos-moving, {acc}", b, 1, warm=False)
        for side in ("closest", "any"):
            key = f"traverse_{short[acc]}_{side}_motion"
            if not lk[key]:
                raise SystemExit(f"the motion frame did not launch {key}")
            frames[(acc, "motion", side)] = lk[key]
        rs = kd_ray_sets(b, dev, motion=True)
        o, d, inv, tmin, tmax, tw = (rs[k] for k in ("o", "d", "inv", "tmin", "tmax", "tw"))
        R = o.shape[0]
        lanes = lambda tm, s: (o[s], d[s], inv[s], tmin[s], tm[s])
        # the first CHUNK lanes are the timing set
        head, rest = rs["timing"], slice(CHUNK, None)

        def plain_all(tm, any_hit, stats):
            """The plain walk on every lane, the timing set's call alone
            timed and counting its work → (hit, ms)."""
            out = {}
            ms = cuda_ms(lambda: out.update(h=plain(g, *lanes(tm, head), any_hit, tw[head],
                                                    stats=stats)), n=1, warm=0)
            tail = plain(g, *lanes(tm, rest), any_hit, tw[rest])
            return [torch.cat(x) for x in zip(out["h"], tail)], ms

        res = {}
        for side, any_hit in (("closest", False), ("any", True)):
            stats = {}
            # any hit below a cut of the plain closest hit's t (p)
            tm = any_tmax(p[0], rs["scale"]) if any_hit else tmax
            p, plain_ms = plain_all(tm, any_hit, stats)
            k = walk(g, o, d, inv, tmin, tm, any_hit, tw)
            ok = p[1] >= 0
            res[side] = (bits(k, p), float((k[0][ok] - p[0][ok]).abs().max()) if ok.any() else 0.0)
            key = f"traverse_{short[acc]}_{side}_motion"
            targs = (g, *lanes(tm, head), any_hit, tw[head])
            tq = timing.queued_rounds(lambda: walk(*targs), RNG_ROUNDS,
                                      TIMING_CALLS["motion"], warm=0)
            nbytes, ops = kd_work(acc, stats, CHUNK, motion=True)
            b_ms, b_by = timing.bound_ms(nbytes, f32_ops=ops)
            entries[key] = dict(max_abs_err=res[side][1], ms=tq["ms"], plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by)
            what = design(key, targs, TIMING_CALLS["motion"], [x[head] for x in p])
            summ = step_summary(stats["lane_steps"], tq["ms"])
            log("timing", f"{key}, the motion scene's permuted set, {CHUNK} lanes: median "
                f"{tq['ms']:.4f} ms over {RNG_ROUNDS} rounds of {TIMING_CALLS['motion']} calls "
                f"({tq['min']:.4f}–{tq['max']:.4f}; plain {plain_ms:.1f} ms); "
                f"{work_text(acc, stats)}, {nbytes} bytes; bound {b_ms:.5f} ms ({b_by}), "
                f"kernel / bound {tq['ms'] / b_ms:.1f}x; passes per lane mean "
                f"{summ['mean']:.2f}, max {summ['max']}; {what}")
        sync()
        log("kernels", f"{acc} motion kernels vs plain on {R} rays of the motion scene (camera "
            f"rays at their own shutter times and bounce rays): equal bit for bit "
            f"{ {s: r[0] for s, r in res.items()} }")
        if not all(r[0] for r in res.values()):
            raise SystemExit(f"a {acc} motion kernel disagrees with its plain version")
        del b, g, o, d, p, k, rs
        torch.cuda.empty_cache()

    # ---- (c) aggregatetest under the BVH, the kd-tree and the grid ---------
    params = ParamSet()
    params.add("integer", "niters", [AGGREGATE_RAYS])
    for acc, b in (("bvh", bvh["built"]), ("kdtree", built["kdtree"]), ("grid", built["grid"])):
        ba = dataclasses.replace(b, renderer_name="aggregatetest", renderer_params=params)
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            files = dispatch.render_scene(ba)
        sync()
        line = out.getvalue().strip()
        n_bad = int(line.split(":")[1].split()[0])
        log("aggregate", f'Renderer "aggregatetest" on killeroo-simple under the {acc}, '
            f"{AGGREGATE_RAYS} rays: {line!r} ({time.time() - t0:.1f} s)")
        if files or n_bad != 0:
            raise SystemExit(f"aggregatetest under the {acc}: {n_bad} rays disagree")
    del built
    torch.cuda.empty_cache()

    # ---- (d) goldens/bunny.pbrt as written ---------------------------------
    bunny_dir = os.path.join(data_dir, "bunny")
    write_bunny_data(bunny_dir)
    t0 = time.time()
    bb = load_checked(bunny_scene(bunny_dir), dev, "goldens/bunny.pbrt")
    g, lt, ic, fc = bb.scene.geometry, bb.scene.lights, bb.integrator, bb.film_config
    disk_row = lt.area_row0
    log("scene", f"goldens/bunny.pbrt as written: {g.num_triangles} triangles (the stand-in "
        f"loop-subdivided from {20 * BUNNY_FREQ ** 2} faces, nlevels 3, and the floor), quadric "
        f"types {g.quad_type.tolist()}, light types {lt.type.tolist()}, the disk light's shape "
        f"kind {int(lt.shape_kind[disk_row])} (a sphere of radius "
        f"{float(g.quad_params[int(lt.quad_idx[disk_row]), 0]):g}, the JAX package's rule), "
        f"material kinds {bb.scene.materials.kind.tolist()}, {ic.kind} depth {ic.max_depth}, "
        f"{fc.xres}x{fc.yres}, {bb.pixel_samples} spp; built in {time.time() - t0:.1f} s")
    if not (g.num_triangles == 2 + 20 * BUNNY_FREQ ** 2 * 64 and g.quad_type.tolist() == [2]
            and int(lt.shape_kind[disk_row]) == 1 and ic.kind == "directlighting"
            and (fc.xres, fc.yres, bb.pixel_samples) == (256, 256, 8)):
        raise SystemExit("goldens/bunny.pbrt did not build as written")
    _, sec, _, _ = drive("goldens/bunny.pbrt as written", bb, bb.pixel_samples)
    profile_frame("goldens/bunny.pbrt as written (directlighting)", bb,
                  sec / bb.pixel_samples * 1e3)
    del bb

    # ---- (e) the refined-shapes room ---------------------------------------
    t0 = time.time()
    br = build(load_scene_string(refined_room_text()), device=dev)
    g = br.scene.geometry
    log("scene", f"refined-shapes room: {g.num_triangles} triangles (a "
        f"{ROOM_HEIGHTFIELD}x{ROOM_HEIGHTFIELD} heightfield floor, "
        f"{2 * (ROOM_HEIGHTFIELD - 1) ** 2} of them; the stand-in loop-subdivided to "
        f"{20 * BUNNY_FREQ ** 2 * 64}; a NURBS patch diced to {2 * 29 * 29}), "
        f"{g.wide_rows.shape[0]} wide rows; built in {time.time() - t0:.1f} s")
    if g.num_triangles != (4 - 2 + 2 * (ROOM_HEIGHTFIELD - 1) ** 2 + 20 * BUNNY_FREQ ** 2 * 64
                           + 2 * 29 * 29):
        raise SystemExit("the refined-shapes room did not build its shapes")
    # timed and counted, not profiled (phase 14's time budget)
    drive("refined-shapes room with path", br, 1)
    del br
    torch.cuda.empty_cache()

    # ---- (f) 16² references -------------------------------------------------
    for acc in ("kdtree", "grid"):
        card_vs_cpu(f"tiny scene, {acc}", accel_scene_text(TINY_SCENE, acc), spp=2,
                    chunk_pixels=256)
    card_vs_cpu("goldens/bunny.pbrt", None, spp=2, chunk_pixels=256,
                scene_path=bunny_scene(bunny_dir, 16))
    for shape in ("heightfield", "loopsubdiv", "nurbs"):
        card_vs_cpu(f"refined-shapes room, {shape} only",
                    refined_room_text(16, 32, (shape,), depth=SCENE_DEPTH), spp=2,
                    chunk_pixels=256)
    for (acc, _, side), n in ((k, v) for k, v in frames.items() if len(k) == 3):
        entries[f"traverse_{short[acc]}_{side}_motion"]["launches"] = n
    for acc in ("kdtree", "grid"):
        for side in ("closest", "any"):
            entries[f"traverse_{short[acc]}_{side}"]["launches"] = sum(
                frames[(acc, kind)]["launches"][f"traverse_{short[acc]}_{side}"]
                for kind in ("directlighting", "path"))
    log("accel", f"phase 14 took {time.time() - t_phase:.1f} s")
    return entries


def kd_work(acc: str, stats: dict, lanes: int, motion: bool):
    """(bytes, float operations) of a kd / grid walk from its plain
    version's counts: each lane's rays and hit, the distinct nodes or
    voxels, CSR ids and primitive rows read; each pass, test and lerp."""
    tri_row = TRI_ROW_BYTES * (2 if motion else 1)
    nbytes = (lanes * (LANE_BYTES_KD_MOTION if motion else LANE_BYTES_KD) + WORLD_BOX_BYTES
              + stats["csr_entries"] * CSR_BYTES + stats["tri_rows"] * tri_row
              + stats["quad_rows"] * QUAD_ROW_BYTES)
    ops = (lanes * OPS_KD_LANE + stats["tri_tests"] * (OPS_TRI_TEST + motion * OPS_TRI_LERP)
           + stats["quad_tests"] * OPS_QUAD_TEST)
    if acc == "kdtree":
        nbytes += stats["nodes"] * KD_NODE_BYTES
        ops += stats["node_steps"] * OPS_KD_NODE + stats["leaf_visits"] * OPS_KD_POP
    else:
        nbytes += stats["voxels"] * VOXEL_BYTES
        ops += stats["steps"] * OPS_VOXEL_STEP
    return nbytes, ops


def work_text(acc: str, stats: dict) -> str:
    where = (f"{stats['node_steps']} interior steps over {stats['nodes']} distinct nodes, "
             f"{stats['leaf_visits']} leaf visits" if acc == "kdtree" else
             f"{stats['steps']} voxel steps over {stats['voxels']} distinct voxels")
    return (f"{where}, {stats['tri_tests']} triangle and {stats['quad_tests']} quadric tests, "
            f"{stats['csr_entries']} CSR ids, {stats['tri_rows']} triangle and "
            f"{stats['quad_rows']} quadric rows")


def chunks_of(b) -> int:
    """Chunks of ``CHUNK`` lanes in a frame of the built scene ``b``."""
    return -(-b.film_config.xres * b.film_config.yres // CHUNK)


TINY_SCENE = """
LookAt 0 1.5 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
SurfaceIntegrator "path" "integer maxdepth" [5]
WorldBegin
AttributeBegin
  Translate 0 4 0
  AreaLightSource "area" "rgb L" [12 12 12]
  Material "matte" "color Kd" [0 0 0]
  Shape "sphere" "float radius" [.6]
AttributeEnd
Material "matte" "color Kd" [.6 .6 .6]
Shape "trianglemesh" "point P" [-20 -1 -20  20 -1 -20  20 -1 20  -20 -1 20]
  "integer indices" [0 1 2 2 3 0]
AttributeBegin
  Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.5 .5 .5]
    "float roughness" [.05]
  Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
  Material "mirror" "rgb Kr" [.8 .8 .8]
  Translate 2.2 0 .5
  Shape "sphere" "float radius" [.8]
AttributeEnd
WorldEnd
"""


def blob_mesh(freq: int = 57, radius: float = 50.0, seed: int = 7):
    """Geodesic icosphere (20·freq² triangles), radially displaced by a
    few seeded sinusoids, resting on z = 0. Returns (P (V,3) f32, idx
    (F,3) i32)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    V = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t],
                  [0, 1, t], [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1],
                  [-t, 0, -1], [-t, 0, 1]], float)
    F = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    n = freq
    ii, jj = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    keep = ii + jj <= n
    ii, jj = ii[keep], jj[keep]
    lid = -np.ones((n + 1, n + 1), int)
    lid[ii, jj] = np.arange(len(ii))
    local = []
    for i in range(n):
        for j in range(n - i):
            local.append((lid[i, j], lid[i + 1, j], lid[i, j + 1]))
            if j < n - i - 1:
                local.append((lid[i + 1, j], lid[i + 1, j + 1], lid[i, j + 1]))
    local = np.array(local)
    pts, tris = [], []
    for f in F:
        a, b, c = V[f]
        w1, w2 = (ii / n)[:, None], (jj / n)[:, None]
        tris.append(local + sum(len(p) for p in pts))
        pts.append(a * (1 - w1 - w2) + b * w1 + c * w2)
    P = np.concatenate(pts)
    P /= np.linalg.norm(P, axis=1, keepdims=True)
    _, first, inv = np.unique(np.round(P * 1e6).astype(np.int64), axis=0,
                              return_index=True, return_inverse=True)
    U = P[first]
    T = inv.ravel()[np.concatenate(tris)]
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(6, 3)) * 2.5
    ph = rng.uniform(0, 2 * np.pi, 6)
    amp = rng.uniform(0.04, 0.1, 6)
    X = U * (radius * (1 + np.sin(U @ k.T + ph) @ amp))[:, None]
    X[:, 2] -= X[:, 2].min()
    return X.astype(np.float32), T.astype(np.int32)


def real_scene_text(freq: int = 57, res: int = 512):
    """The real-size scene's text with the generated blob at ``freq`` and
    the film at res × res; → (text, triangles per blob)."""
    P, idx = blob_mesh(freq)
    mesh = mesh_text(P, idx)
    text = KILLEROO_SIMPLE.replace("@MESH@", mesh).replace(
        '"integer xresolution" [512] "integer yresolution" [512]',
        f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    return text, len(idx)


def mesh_text(P, idx) -> str:
    return ('Shape "trianglemesh" "point P" [' + " ".join(f"{v:.6g}" for v in P.ravel())
            + ']\n  "integer indices" [' + " ".join(map(str, idx.ravel())) + "]\n")


#: goldens/anim-killeroos-moving.pbrt's reference to the absent geometry
ANIM_INCLUDE = 'Include "geometry/killeroo.pbrt"'


def anim_scene_text(freq: int = 57, res: int | None = None) -> str:
    """``goldens/anim-killeroos-moving.pbrt`` as written (its text read from
    the repository), each ``Include "geometry/killeroo.pbrt"`` the
    generated blob at ``freq``; the film at res × res if given."""
    with open(os.path.join(HERE, "goldens", "anim-killeroos-moving.pbrt")) as f:
        text = f.read()
    if text.count(ANIM_INCLUDE) != 2:
        raise ValueError("goldens/anim-killeroos-moving.pbrt: expected two killeroo includes")
    text = text.replace(ANIM_INCLUDE, mesh_text(*blob_mesh(freq)))
    if res is not None:
        text = text.replace('"integer xresolution" [256] "integer yresolution" [256]',
                            f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    return text


def instanced_scene_text(freq: int = 57, res: int = 512, grid=(8, 8),
                         flatten: bool = False) -> str:
    """The killeroo-simple scene (``path``, depth 5) with its two blobs
    replaced by one blob declared in ``ObjectBegin "blob"`` and used by
    static ``ObjectInstance``s on a grid of nx × ny, 40 units apart in
    the blobs' frame, each use turned about z by its own angle and scaled
    by .3; ``flatten`` writes each use's mesh out in its place instead."""
    mesh = mesh_text(*blob_mesh(freq))
    head = KILLEROO_SIMPLE[:KILLEROO_SIMPLE.index("AttributeBegin\nScale .5 .5 .5")]
    head = head.replace('SurfaceIntegrator "directlighting"',
                        'SurfaceIntegrator "path" "integer maxdepth" [5]').replace(
        '"integer xresolution" [512] "integer yresolution" [512]',
        f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    material = ('Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.5 .5 .5] '
                '"float roughness" [.025]\n')
    nx, ny = grid
    uses = []
    for k in range(nx * ny):
        i, j = divmod(k, ny)
        x, y = -20 * (nx - 1) + 40 * i, 200 - 20 * (ny - 1) + 40 * j
        uses.append(f"AttributeBegin\n  Translate {x} {y} -140\n  Rotate {(47 * k) % 360} 0 0 1\n"
                    f"  Scale .3 .3 .3\n  {mesh if flatten else 'ObjectInstance \"blob\"'}\n"
                    "AttributeEnd\n")
    obj = "" if flatten else f'ObjectBegin "blob"\n{mesh}ObjectEnd\n'
    return (head + material + obj + "AttributeBegin\nScale .5 .5 .5\nRotate -60 0 0 1\n"
            + "".join(uses) + "AttributeEnd\nWorldEnd\n")


def lights_scene_text(text: str, integrator: str = "directlighting") -> str:
    """A real-size scene's text with LIGHTS_AND_QUADRICS added and the
    given surface integrator."""
    text = text.replace('SurfaceIntegrator "directlighting"', f'SurfaceIntegrator "{integrator}"')
    return text.replace("WorldBegin", "WorldBegin" + LIGHTS_AND_QUADRICS, 1)


#: what the texture-kinds scene adds to the real-size scene, right after
#: WorldBegin: its textures (@DIR@ is the directory of the generated
#: images), then twelve spheres ~200 units in front of the camera, each in
#: one more texture kind, mapping or map: dots (uv), fbm, wrinkled and windy
#: (3D), bilerp (spherical, about the sphere's centre), uv (planar), a mix
#: of a spherical checkerboard and fbm, a scaled imagemap, a normal map, a
#: bump map, a mix material whose sub-materials have textured Kd, and a 2D
#: checkerboard of two constants
TEXTURE_KINDS = """
Texture "floor-map" "color" "imagemap" "string filename" ["@DIR@/textures/lines.exr"]
    "float uscale" [5] "float vscale" [5]
Texture "wall-checks" "color" "checkerboard" "float uscale" [4] "float vscale" [4]
    "rgb tex1" [.8 .8 .7] "rgb tex2" [.2 .25 .4]
Texture "dots" "color" "dots" "float uscale" [8] "float vscale" [6] "rgb tex1" [.9 .3 .1]
    "rgb tex2" [.2 .5 .7]
TransformBegin
Scale 20 20 20
Texture "checks3d" "color" "checkerboard" "integer dimension" [3] "rgb tex1" [.8 .7 .2]
    "rgb tex2" [.1 .3 .5]
Texture "fbm" "color" "fbm"
Texture "wrinkled" "color" "wrinkled"
Texture "windy" "color" "windy"
Texture "marble" "color" "marble" "rgb tex1" [.85 .8 .75] "rgb tex2" [.3 .15 .1]
    "float variation" [.5]
Texture "wrinkle-base" "float" "wrinkled"
TransformEnd
Texture "bump-wrinkle" "float" "scale" "texture tex1" "wrinkle-base" "float tex2" [.05]
TransformBegin
Translate 202 -6 -56
Rotate 90 1 0 0
Texture "bilerp" "color" "bilerp" "string mapping" ["spherical"] "rgb tex1" [.9 .8 .1]
    "rgb tex2" [.1 .3 .9]
TransformEnd
TransformBegin
Translate 204 58 -56
Rotate 90 1 0 0
Texture "checks-sph" "color" "checkerboard" "string mapping" ["spherical"]
    "float uscale" [8] "float vscale" [8] "rgb tex1" [.9 .9 .9] "rgb tex2" [.1 .1 .1]
TransformEnd
TransformBegin
Translate 203 26 -56
Scale 10 10 10
Texture "uv-planar" "color" "uv" "string mapping" ["planar"]
TransformEnd
Texture "mixed" "color" "mix" "texture tex1" "checks-sph" "texture tex2" "fbm" "float amount" [.35]
Texture "scaled-map" "color" "scale" "texture tex1" "floor-map" "rgb tex2" [.7 .9 .6]
Texture "nmap" "color" "imagemap" "string filename" ["@DIR@/textures/normal.exr"]
    "float uscale" [3] "float vscale" [2]
MakeNamedMaterial "dotted" "string type" ["matte"] "texture Kd" "dots"
MakeNamedMaterial "veined" "string type" ["plastic"] "texture Kd" "marble"
    "color Ks" [.3 .3 .3] "float roughness" [.05]
@SPHERES@
"""
_TEXTURE_SPHERE_MATERIALS = (
    'Material "matte" "texture Kd" "dots"',
    'Material "matte" "texture Kd" "fbm"',
    'Material "matte" "texture Kd" "wrinkled"',
    'Material "matte" "texture Kd" "windy"',
    'Material "matte" "texture Kd" "bilerp"',
    'Material "matte" "texture Kd" "uv-planar"',
    'Material "plastic" "texture Kd" "mixed" "color Ks" [.4 .4 .4] "float roughness" [.03]',
    'Material "matte" "texture Kd" "scaled-map"',
    'Material "matte" "color Kd" [.6 .6 .6] "texture normalmap" "nmap"',
    'Material "plastic" "color Kd" [.5 .4 .3] "color Ks" [.3 .3 .3] "float roughness" [.05]\n'
    '    "texture bumpmap" "bump-wrinkle"',
    'Material "mix" "string namedmaterial1" ["dotted"] "string namedmaterial2" ["veined"]\n'
    '    "float amount" [.4]',
    'Material "matte" "texture Kd" "wall-checks"',
)
#: the spheres' centres, three rows of four (the second row's first,
#: second and third centres are the spherical, planar and spherical
#: textures' origins; the spherical frames have their poles on the
#: spheres' sides, since the mapping's θ = acos(z / r) is ill-conditioned
#: at a pole)
_TEXTURE_SPHERE_AT = tuple((196 + 6 * r + k, -6 + 32 * k, -18 - 38 * r)
                           for r in range(3) for k in range(4))
#: killeroo-simple's materials as the texture-kinds scene changes them: the
#: floor in an imagemap, the wall in a 2D checkerboard, one blob in a 3D
#: checkerboard, the other in marble
TEXTURE_SWAPS = (
    ('Material "matte" "color Kd" [.5 .5 .8]', 'Material "matte" "texture Kd" "floor-map"'),
    ('Shape "trianglemesh" "point P" [ -400',
     'Material "matte" "texture Kd" "wall-checks"\nShape "trianglemesh" "point P" [ -400'),
    ('Material "plastic" "color Kd" [.4 .2 .2] "color Ks" [.5 .5 .5]\n        "float roughness" [.025]',
     'Material "plastic" "texture Kd" "checks3d" "color Ks" [.3 .3 .3] "float roughness" [.05]'),
    ('Material "plastic" "color Ks" [.3 .3 .3] "color Kd" [.4 .5 .4]\n        "float roughness" [.15]',
     'Material "matte" "texture Kd" "marble"'),
)


def texture_kinds_text(text: str, directory: str, integrator: str = "path") -> str:
    """A real-size scene's text made the texture-kinds scene (images under
    ``directory``/textures) with the given surface integrator."""
    for old, new in TEXTURE_SWAPS:
        if old not in text:
            raise ValueError(f"the scene text has no {old!r}")
        text = text.replace(old, new, 1)
    spheres = "".join(f"AttributeBegin\n{m}\nTranslate {x} {y} {z}\n"
                      f'Shape "sphere" "float radius" [14]\nAttributeEnd\n'
                      for m, (x, y, z) in zip(_TEXTURE_SPHERE_MATERIALS, _TEXTURE_SPHERE_AT))
    text = text.replace('SurfaceIntegrator "directlighting"', f'SurfaceIntegrator "{integrator}"')
    return text.replace("WorldBegin", "WorldBegin" + TEXTURE_KINDS.replace("@DIR@", directory)
                        .replace("@SPHERES@", spheres), 1)


def write_texture_data(directory: str, teapot_freq: int = 57, seed: int = 13):
    """What ``goldens/metal.pbrt`` reads (its files are not in the
    repository), generated from a fixed numpy seed under ``directory``:
    ``textures/lines.exr`` (300×200, not a power of two, so the Lanczos
    resample runs: soft wavy lines), ``textures/grace_latlong.exr``
    (1024×512 lat-long sky with a bright Gaussian patch),
    ``spds/metals/Au.eta.spd`` and ``Au.k.spd`` (smooth two-column curves
    over 380–720 nm, gold's shape), ``geometry/room-teapot.pbrt``
    (``blob_mesh(teapot_freq)`` of radius 3 standing on y = 0: 64,980
    triangles at the default frequency) and, for the texture-kinds scene,
    ``textures/normal.exr`` (a 64×64 tangent-space normal map)."""
    from pbrt_torch.film.imageio import write_exr

    rng = np.random.default_rng(seed)
    for sub in ("textures", "spds/metals", "geometry"):
        os.makedirs(os.path.join(directory, sub), exist_ok=True)
    # smooth images, lines 100 texels apart: past the first hit a lookup has
    # no footprint and reads level 0, and after the teapot's near-mirror
    # reflection an ulp of difference (the card's arithmetic is not the
    # CPU's) moves a grazing floor hit by many ulps; the lookup then moves
    # by the image's slope times that shift, which sharp lines or a
    # hard-edged patch carry past the card-vs-CPU tolerance on a few per
    # cent of metal.pbrt's lanes (phase 5's and 10's logs give each scene's
    # CPU against itself with the image samples an ulp over)
    yy, xx = np.mgrid[0:200, 0:300].astype(np.float32)
    lines = 0.35 + 0.25 * (1.0 + np.cos(xx * (2 * np.pi / 100) + 0.3 * np.sin(yy / 15)))
    img = np.stack([lines, lines * (0.8 + 0.2 * yy / 200), lines * 0.7], -1).astype(np.float32)
    write_exr(os.path.join(directory, "textures", "lines.exr"), img, half=False)
    v = (np.arange(512) + 0.5) / 512
    u = (np.arange(1024) + 0.5) / 1024
    sky = np.empty((512, 1024, 3), np.float32)
    sky[:] = (0.2 + 0.8 * (1.0 - v))[:, None, None] * np.array([0.55, 0.7, 1.0], np.float32)
    patch = np.exp(-((v[:, None] - 0.25) ** 2 + (u[None, :] - 0.3) ** 2) / 0.0008)
    sky += patch[..., None] * np.array([60.0, 55.0, 45.0], np.float32)
    write_exr(os.path.join(directory, "textures", "grace_latlong.exr"), sky, half=False)
    lam = np.linspace(380.0, 720.0, 35)
    t = (lam - 380.0) / 340.0
    for name, vals in (("eta", 1.45 - 1.25 * t ** 0.7), ("k", 1.8 + 2.7 * t)):
        with open(os.path.join(directory, "spds", "metals", f"Au.{name}.spd"), "w") as f:
            f.write("\n".join(f"{a:g} {b:.6g}" for a, b in zip(lam, vals)) + "\n")
    P, idx = blob_mesh(teapot_freq, radius=3.0)
    P = np.stack([P[:, 0], P[:, 2], -P[:, 1]], -1)  # stand on y = 0 (a rotation)
    with open(os.path.join(directory, "geometry", "room-teapot.pbrt"), "w") as f:
        f.write('Shape "trianglemesh" "point P" [' + " ".join(f"{x:.6g}" for x in P.ravel())
                + ']\n  "integer indices" [' + " ".join(map(str, idx.ravel())) + "]\n")
    ny, nx = np.mgrid[0:64, 0:64] * (2 * np.pi / 64)
    n = np.stack([0.35 * np.sin(2 * nx), 0.35 * np.cos(3 * ny), np.ones_like(nx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    write_exr(os.path.join(directory, "textures", "normal.exr"),
              (0.5 + 0.5 * n).astype(np.float32), half=False)


# ---------------------------------------------------------------------------
# phase 15: the preprocess integrators and goldens/ss-envmap.pbrt
# ---------------------------------------------------------------------------

#: what goldens/ss-envmap.pbrt reads, generated (``write_ss_envmap_data``):
#: the stand-in teapot's blob frequency (20·f² triangles)
SS_TEAPOT_FREQ = 40
#: the room's two walls (a matte corner behind the teapot, open to the sky
#: and the floor's) in the teapot's object space, before the golden's
#: Scale 1.25 and Translate 15 0 10
SS_ROOM = """AttributeBegin
  Material "matte" "color Kd" [.55 .5 .45]
  Shape "trianglemesh" "point P" [-8 0 8  8 0 8  8 9 8  -8 9 8  -8 0 -8  -8 9 -8]
    "integer indices" [0 1 2 0 2 3  0 3 5 0 5 4]
AttributeEnd
"""
#: the three integrators phase 15 puts into killeroo-simple at 256², 1 spp
KILLEROO_PREPROCESS = ("irradiancecache", "photonmap", "igi")
#: the 16² references' integrators: on the tiny scene with the
#: ``SUBSURFACE_BOXES``, closed into the ``SUBSURFACE_ROOM``
PREPROCESS_REF = {
    "dipolesubsurface": '"dipolesubsurface" "integer maxdepth" [2]',
    "photonmap": '"photonmap" "integer maxdepth" [2] "integer indirectphotons" [16384]',
    "igi": '"igi" "integer maxdepth" [2] "integer nlights" [64]',
    "irradiancecache": '"irradiancecache" "integer maxdepth" [2]',
}
#: a subsurface and a kdsubsurface box
SUBSURFACE_BOXES = """AttributeBegin
 Translate -2 -0.2 1
 Material "subsurface" "color sigma_a" [.05 .05 .05] "color sigma_prime_s" [3 3 3]
 Shape "trianglemesh" "point P" [-.8 -.8 -.8  .8 -.8 -.8  .8 .8 -.8  -.8 .8 -.8
   -.8 -.8 .8  .8 -.8 .8  .8 .8 .8  -.8 .8 .8]
  "integer indices" [0 2 1 0 3 2  4 5 6 4 6 7  0 1 5 0 5 4  2 3 7 2 7 6  1 2 6 1 6 5  0 4 7 0 7 3]
AttributeEnd
AttributeBegin
 Translate 1 -0.5 -1.5
 Material "kdsubsurface" "color Kd" [.6 .4 .3] "float meanfreepath" [.4]
 Shape "trianglemesh" "point P" [-.4 -.4 -.4  .4 -.4 -.4  .4 .4 -.4  -.4 .4 -.4
   -.4 -.4 .4  .4 -.4 .4  .4 .4 .4  -.4 .4 .4]
  "integer indices" [0 2 1 0 3 2  4 5 6 4 6 7  0 1 5 0 5 4  2 3 7 2 7 6  1 2 6 1 6 5  0 4 7 0 7 3]
AttributeEnd
"""
#: four walls and a ceiling closing the tiny scene's floor into a room (the
#: camera inside), so that light paths stay in the scene
SUBSURFACE_ROOM = """AttributeBegin
 Material "matte" "color Kd" [.5 .45 .4]
 Shape "trianglemesh" "point P" [-5 -1 -7  5 -1 -7  5 6 -7  -5 6 -7
   -5 -1 5  5 -1 5  5 6 5  -5 6 5]
  "integer indices" [0 1 2 0 2 3  4 6 5 4 7 6  0 3 7 0 7 4  1 5 6 1 6 2  3 2 6 3 6 7]
AttributeEnd
"""
#: the Mo gather's float operations per (active lane, point, bin), counted
#: from dipole.cu: the two depths' d² + z² (2), per side dpos·σtr + 1, z·
#: that, −σtr·dpos, the product, dpos³ (2), σ′t·dpos³, the max (8), then
#: α′/4π·(pos − neg), the max, ·E·A and the tile sum (5); 2 sqrtf counted
#: as 4 each (MUFU.RSQ and its Newton steps), 2 expf as 8 (range reduction,
#: ex2 and scale), 2 IEEE divides as 8 (MUFU.RCP, Newton, correction)
OPS_MO_PER_BIN = 2 + 2 * 8 + 5 + 2 * 4 + 2 * 8 + 2 * 8
#: per (active lane, point): p·q (5), −2·, the two adds and the clamp (4)
OPS_MO_PER_POINT = 9
#: the chain kernel's integer work per lane: the (index, sample) key (2
#: keys); per group its tags' fold-ins (a key and the tag's adds each); per
#: uniform a hash and the counter's divide and modulo (2)
OPS_CHAIN_GROUP_TAG = 2 + OPS_HASH + OPS_KEY_SCHEDULE


def write_ss_envmap_data(directory: str, teapot_freq: int = SS_TEAPOT_FREQ):
    """What ``goldens/ss-envmap.pbrt`` reads, generated under ``directory``:
    ``textures/lines.exr`` and ``textures/grace_latlong.exr`` (phase 10's
    300×200 stripes and 1024×512 sky) and ``geometry/room-teapot.pbrt``: a
    matte corner of two walls (``SS_ROOM``) and a closed teapot-sized blob
    (radius 3 on y = 0, 20·f² triangles), which takes the golden's
    subsurface material."""
    write_texture_data(directory, teapot_freq=2)
    P, idx = blob_mesh(teapot_freq, radius=3.0)
    P = np.stack([P[:, 0], P[:, 2], -P[:, 1]], -1)  # stand on y = 0 (a rotation)
    with open(os.path.join(directory, "geometry", "room-teapot.pbrt"), "w") as f:
        f.write(SS_ROOM + mesh_text(P, idx))
    return len(idx)


def ss_envmap_scene(directory: str, res: int | None = None, spp: int | None = None,
                    renderer: str = "") -> str:
    """``goldens/ss-envmap.pbrt`` as written, into ``directory`` beside its
    generated files (at res², spp samples and with a ``Renderer`` line if
    given); → its path."""
    with open(os.path.join(HERE, "goldens", "ss-envmap.pbrt")) as f:
        text = f.read()
    if res is not None:
        text = text.replace('"integer xresolution" [128] "integer yresolution" [128]',
                            f'"integer xresolution" [{res}] "integer yresolution" [{res}]')
    if spp is not None:
        text = text.replace('"integer pixelsamples" [64]', f'"integer pixelsamples" [{spp}]')
    if renderer:
        text = text.replace("WorldBegin", renderer + "\nWorldBegin", 1)
    path = os.path.join(directory, f"ss-envmap{res or ''}{'-sp' if renderer else ''}.pbrt")
    with open(path, "w") as f:
        f.write(text)
    return path


#: the sparse Mo-gather set's active share, standing for the later bounces
MO_SPARSE_SHARE = 0.05


def mo_lane_sets(built, dev, seed: int = 23) -> dict:
    """Phase 15's Mo-gather lanes of ``goldens/ss-envmap.pbrt`` as its
    checks and timings and ``scripts/mo_lab.py`` take them: ``CHUNK`` first
    hits of the camera rays of samples 0 and 1 of chunk 0. → dict of si
    (their interactions), p (R, 3), prm (7, R, S) (``_lane_params``
    stacked), table (``_point_table``), active (the subsurface hits),
    sparse (``MO_SPARSE_SHARE`` of the R lanes, drawn from the active ones
    with ``seed``) and root (the render's root key)."""
    import torch

    from pbrt_torch.accel.intersect import intersect
    from pbrt_torch.core.interaction import surface_interaction
    from pbrt_torch.integrators import dipole
    from pbrt_torch.materials import table as mat_mod
    from pbrt_torch.renderers import sampler as sampler_mod

    sc = built.scene
    xs, ys, pix, mask, root, scr = sampler_mod.pixel_chunks(built, 0, CHUNK)
    u = torch.cat([sampler_mod.wave_uniforms(built.integrator, root, pix[0], scr[0], s,
                                             "lowdiscrepancy", 64) for s in (0, 1)])
    px = torch.cat([xs[0], xs[0]]).to(torch.float32) + u[:, 0]
    py = torch.cat([ys[0], ys[0]]).to(torch.float32) + u[:, 1]
    rays = built.camera.generate_rays(px, py, u[:, 2], u[:, 3], u[:, 4])
    g = sc.geometry
    si = surface_interaction(g, rays, intersect(g, rays))
    mk = sc.materials.kind[si.material.clamp(min=0)]
    active = si.valid & ((mk == mat_mod.SUBSURFACE) | (mk == mat_mod.KDSUBSURFACE))
    R = rays.origin.shape[0]
    prm = torch.stack([x.expand(R, -1) for x in dipole._lane_params(sc.materials, si.material)])
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    on = torch.nonzero(active).flatten()
    keep = on[torch.randperm(on.numel(), generator=gen, device=dev)[:round(MO_SPARSE_SHARE * R)]]
    sparse = torch.zeros_like(active)
    sparse[keep] = True
    return dict(si=si, p=si.p.contiguous(), prm=prm.contiguous(),
                table=dipole._point_table(sc.subsurface), active=active, sparse=sparse,
                root=root)


def preprocess_phase(dev, data_dir, drive, profile_frame, card_vs_cpu):
    """Phase 15: ``goldens/ss-envmap.pbrt`` as written under
    dipolesubsurface; killeroo-simple under irradiancecache, photonmap and
    igi; ``Renderer "surfacepoints"``; the chain and Mo-gather kernels
    against their plain versions and timed; the 16² references. → the
    kernels line's entries."""
    import torch

    from pbrt_torch.core import rng
    from pbrt_torch.integrators import dipole, igi as igi_mod, irradiance
    from pbrt_torch.renderers.dispatch import render_scene
    from pbrt_torch.renderers.surface_points import read_points_file
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build
    from pbrt_torch.utils import native, timing
    from pbrt_torch.utils.timing import cuda_ms

    sync = torch.cuda.synchronize
    t_phase = time.time()
    n_teapot = write_ss_envmap_data(data_dir)

    def built_counted(what, load):
        """Builds (and preprocesses) with threefry's torch ops counted: the
        preprocess draws through the chain kernel only. → (built, s)."""
        t0 = time.time()
        rng.reset_launches()
        with mock.patch.object(rng, "threefry2x32", wraps=rng.threefry2x32) as tf:
            b = load()
            sync()
        if tf.call_count:
            raise SystemExit(f"{what}: the preprocess ran threefry in torch ops on the card")
        return b, time.time() - t0

    # ---- (a) goldens/ss-envmap.pbrt as written --------------------------
    ss_path = ss_envmap_scene(data_dir)
    ss_built, build_s = built_counted("goldens/ss-envmap.pbrt",
                                      lambda: load_checked(ss_path, dev, "goldens/ss-envmap.pbrt"))
    sc, fc, ic = ss_built.scene, ss_built.film_config, ss_built.integrator
    ss = sc.subsurface
    E_lum = ss.E.mean(-1) if ss is not None else None
    log("scene", f"goldens/ss-envmap.pbrt as written: {sc.geometry.num_triangles} triangles "
        f"(the stand-in teapot {n_teapot}, the room's 4, the floor's 2), env map "
        f"{tuple(sc.lights.env_map.shape)}, {ic.kind} depth {ic.max_depth}, {fc.xres}x{fc.yres}, "
        f"{ss_built.pixel_samples} spp; {ss.points.shape[0] if ss is not None else 0} surface "
        f"points, E (mean over bins) min {float(E_lum.min()):.6g} max {float(E_lum.max()):.6g}, "
        f"{int((E_lum > 0).sum())} lit; built with the preprocess in {build_s:.1f} s (keyed "
        f"chain launches {rng.launches['keyed_chain_uniforms']})")
    if not (ic.kind == "dipolesubsurface" and sc.has_subsurface and sc.has_textures
            and ss.points.shape[0] == dipole.MAX_POINTS and float(E_lum.max()) > 0
            and (fc.xres, fc.yres, ss_built.pixel_samples) == (128, 128, 64)
            and rng.launches["keyed_chain_uniforms"] == 1):
        raise SystemExit("goldens/ss-envmap.pbrt did not build as written with its stand-ins")
    spp = ss_built.pixel_samples
    film, sec, lk, _ = drive("goldens/ss-envmap.pbrt as written", ss_built, spp)
    prof = profile_frame("goldens/ss-envmap.pbrt, chunk 0", ss_built, sec / spp * 1e3,
                         run=chunk_wave(ss_built, dev), scale=chunks_of(ss_built))
    mo_launches = lk["mo_gather"]
    log("render", f"goldens/ss-envmap.pbrt: mo_gather's kernels launched {mo_launches} times "
        f"(two a call: the lane list and the gather) in the {spp}-spp frame "
        f"({mo_launches / spp:.1f} per wave), {prof.get('mo_gather_ms', 0):.3f} "
        f"ms of the profiled wave's {prof['ms']:.3f} ms kernel time "
        f"({100 * prof.get('mo_gather_ms', 0) / max(prof['ms'], 1e-9):.1f}%)")
    if mo_launches == 0:
        raise SystemExit("goldens/ss-envmap.pbrt: the frame did not launch the Mo gather")

    # ---- (b) killeroo-simple under the other three ----------------------
    text, _ = real_scene_text(res=256)
    chain_launches = 0
    for kind in KILLEROO_PREPROCESS:
        b, pre_s = built_counted(f"killeroo-simple with {kind}", lambda: build(load_scene_string(
            text.replace('SurfaceIntegrator "directlighting"', f'SurfaceIntegrator "{kind}"')),
            device=dev))
        if b.integrator.kind != kind:
            raise SystemExit(f"killeroo-simple did not build with {kind}")
        what = ""
        if kind == "photonmap":
            ph = b.scene.photons
            what = (f"{ph.p.shape[0]} photon slots ({ph.p.shape[0] // 5} paths of depth 5), "
                    f"{int(ph.valid.sum())} photons, {int(ph.is_caustic.sum())} caustic, radius "
                    f"{float(ph.radius):.5g}")
        elif kind == "igi":
            what = f"{b.scene.vpls.p.shape[0]} VPL slots, {int(b.scene.vpls.valid.sum())} VPLs"
        log("scene", f"killeroo-simple with {kind}, 256x256: built with its preprocess in "
            f"{pre_s:.2f} s{', ' + what if what else ''}")
        film, sec, lk, _ = drive(f"killeroo-simple with {kind}", b, 1, warm=False)
        profile_frame(f"killeroo-simple with {kind}, chunk 0", b, sec * 1e3,
                      run=chunk_wave(b, dev),
                      scale=chunks_of(b))
        chain_launches += lk["keyed_chain_uniforms"]

    # ---- (c) Renderer "surfacepoints" on the stand-in -------------------
    t0 = time.time()
    pts_path = os.path.join(data_dir, "ss.pts")
    sp_built = load_checked(ss_envmap_scene(data_dir, renderer=(
        'Renderer "surfacepoints" "float minsampledistance" [.1] '
        f'"string filename" ["{pts_path}"]')), dev, "ss-envmap with surfacepoints")
    if render_scene(sp_built) != [pts_path]:
        raise SystemExit("surfacepoints wrote no points file")
    pts = torch.as_tensor(read_points_file(pts_path)[0], device=dev)
    d_min = math.inf
    for c0 in range(0, pts.shape[0], 4096):
        d = torch.cdist(pts[c0:c0 + 4096], pts, compute_mode="donot_use_mm_for_euclid_dist")
        d[torch.arange(d.shape[0], device=dev), torch.arange(c0, c0 + d.shape[0], device=dev)] = 1e9
        d_min = min(d_min, float(d.min()))
    sync()
    # the file's 6 significant digits move a coordinate (< 100) by ≤ 5e-5,
    # a distance by ≤ √3 · 1e-4
    log("surfacepoints", f"Renderer \"surfacepoints\" (minsampledistance .1) on the ss-envmap "
        f"stand-in: {pts.shape[0]} points written to the file in {time.time() - t0:.1f} s, "
        f"pairwise minimum distance {d_min:.6f} (the file's %g rounding moves it by < 1.8e-4)")
    if not (pts.shape[0] > 1000 and d_min >= 0.1 - 1.8e-4):
        raise SystemExit("surfacepoints: too few points, or two closer than minsampledistance")

    # ---- (d) the kernels against their plain versions --------------------
    # B: 32,768 lanes of ss-envmap's first bounce (camera rays of two samples)
    mo_sets = mo_lane_sets(ss_built, dev)
    si, prm, table, p_c = mo_sets["si"], mo_sets["prm"], mo_sets["table"], mo_sets["p"]
    root = mo_sets["root"]
    R = p_c.shape[0]
    Np, S = table[0].shape[0], table[2].shape[1]
    n_pts = ss.points.shape[0]
    lib = native.kernel_lib("dipole.cu")
    info = dipole.kernel_info(lib)
    # the main path's instance (the template's other one counts checked tiles)
    sass = sass_loop_stats(lib._name, "mo_gather_kernelILb0E", info["tile"] // info["group"])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log("build", f"dipole.cu mo_gather_kernel: one lane a warp (k = 1), "
        f"{info['threads']} threads a block, {info['registers']} registers, "
        f"{info['local_bytes']} local bytes, {info['blocks_per_sm']} blocks per SM; SASS per "
        f"(lane, point) issued {sass['issued']['instructions']:.2f} (MUFU "
        f"{sass['issued']['MUFU']:.2f}, LDS {sass['issued']['LDS']:.3f}, BRA "
        f"{sass['issued']['BRA']:.3f}), written {sass['static']['instructions']:.2f}")
    # each set bit for bit against the plain version, then timed beside its
    # operation bound and its issue-slot bound at the SM clock read meanwhile
    mo_rows = {}
    for set_name in ("active", "sparse"):
        act = mo_sets[set_name]
        a8 = act.to(torch.uint8)
        k = dipole.mo_gather_kernel(prm, p_c, a8, table)
        pl = dipole.mo_gather_plain(ss, sc.materials, si.p, si.material, act,
                                    params=tuple(prm), table=table)
        sync()
        if not torch.equal(k.view(torch.int32), pl.view(torch.int32)):
            raise SystemExit(f"mo_gather disagrees with its plain version on ss-envmap's "
                             f"{set_name} lanes")
        n_act = int(act.sum())
        tiles = torch.zeros(1, dtype=torch.int64, device=dev)
        dipole.launch_with(lib, prm, p_c, a8, table, checked=tiles)
        checked = int(tiles) / max(n_act * (Np // dipole.TILE), 1)
        with SmClock() as clk:
            tq = timing.queued_rounds(lambda: dipole.mo_gather_kernel(prm, p_c, a8, table),
                                      RNG_ROUNDS, calls=10, warm=2)
        plain_ms = cuda_ms(lambda: dipole.mo_gather_plain(ss, sc.materials, si.p, si.material,
                                                          act, params=tuple(prm), table=table),
                           n=1, warm=0)
        mo_bound, mo_by = timing.bound_ms(
            7 * R * S * 4 + R * (12 + 1) + Np * (3 + 1 + S) * 4 + R * S * 4,
            f32_ops=n_act * n_pts * (OPS_MO_PER_POINT + S * OPS_MO_PER_BIN))
        issue = (issue_bound_ms(n_act, Np, sass["issued"]["instructions"], clk.mhz, sms)
                 if clk.mhz else None)
        mo_rows[set_name] = dict(err=float((k - pl).abs().max()), tq=tq, plain_ms=plain_ms,
                                 bound=mo_bound, by=mo_by)
        log("timing", f"mo_gather on {R} lanes of ss-envmap's first hits, {n_act} active "
            f"({set_name} set), {n_pts} points, {S} bins: bit for bit equal to its plain "
            f"version; median {tq['ms']:.4f} ms over {RNG_ROUNDS} rounds ({tq['min']:.4f}–"
            f"{tq['max']:.4f}; plain {plain_ms:.1f} ms); bound {mo_bound:.4f} ms ({mo_by}: "
            f"{n_act} x {n_pts} x ({S} x {OPS_MO_PER_BIN} + {OPS_MO_PER_POINT}) float "
            f"operations), kernel / bound {tq['ms'] / mo_bound:.2f}x; issue-slot bound "
            + (f"{issue:.4f} ms ({n_act} x {Np} x {sass['issued']['instructions']:.2f} warp "
               f"instructions over {sms} x 4 schedulers at {clk.mhz:g} MHz), kernel / issue "
               f"bound {tq['ms'] / issue:.2f}x" if issue else "not measured (no SM clock read)")
            + f"; one lane a warp, {info['registers']} registers, "
            f"{info['blocks_per_sm']} blocks per SM; (active lane, tile) pairs on the checked "
            f"terms {100 * checked:.3f}%")
    mo_main = mo_rows["active"]
    # A: every chain of the slice, on 1,048,576 lanes and ragged ones; every
    # shape the integrators call on 32,768, 4,093, 7 and 1 lanes
    depth = 5
    gather = ((irradiance.FILL_SALT + 100) * 16 + rng.CAMERA, 4)
    chains = {
        "dipole irradiance": dict(chain=[(rng.LIGHT_SAMPLE, 4)], n=3),
        "light path start": dict(n=5),
        "light path bounces": dict(chain=[(rng.PHOTON, depth)], n=3),
        "VPL picks": dict(chain=[(rng.PHOTON, depth), (rng.PHOTON, igi_mod.VPL_SAMPLES)]),
        "cache directions": dict(chain=[(irradiance.FILL_SALT * 16 + rng.BSDF_SAMPLE, 4)], n=2),
        "nested blocks": dict(chain=[gather, rng.BATCHED], n=7 * depth, used=7, drawn=8, lead=5),
    }
    shapes = dict(chains, **{
        "AO directions": dict(chain=[(rng.BSDF_SAMPLE, 4)], n=2, lead=rng.CAMERA_DIMS),
        "bounce block": dict(chain=[rng.BATCHED], n=rng.PER_BOUNCE_USED * depth,
                             used=rng.PER_BOUNCE_USED, drawn=rng.PER_BOUNCE_DRAWN,
                             lead=rng.CAMERA_DIMS),
        "PRT's bounce block": dict(chain=[rng.BATCHED], n=rng.PER_BOUNCE_USED,
                                   used=rng.PER_BOUNCE_USED, drawn=rng.PER_BOUNCE_DRAWN,
                                   lead=rng.CAMERA_DIMS),
        "cache jitters": dict(chain=[gather, (rng.VOLUME, depth)]),
        "glossyprt": dict(chain=[(rng.BSDF_SAMPLE, 64)], n=3),
        "cache steps": dict(chain=[gather, rng.VOLUME, (rng.LIGHT_SAMPLE, rng.VOLUME_STEPS)],
                            n=rng.PER_VOLUME_STEP),
        "2,100 columns, three tiles": dict(chain=[(rng.PHOTON, 700)], n=3),
        "ragged": dict(chain=[3, (7, 3), 11, (2**32 - 33, 3)], n=9, used=4, drawn=6, lead=2),
        "a row a thread": dict(chain=[(rng.PHOTON, 6)], lead=2)})
    idx = torch.cat([torch.tensor(PIXELS_WRAP, dtype=torch.int64, device=dev),
                     torch.arange(N_LANES, dtype=torch.int64, device=dev)])
    err_chain, n_cases = 0.0, 0
    small = [(idx[:n], sample) for n in (CHUNK, 4093, 7, 1) for sample in (0, 3, 2**31 + 1)]
    for name_, kw in shapes.items():
        sets = small + ([(idx[:N_LANES], 0), (idx[:N_LANES], 2**31 + 1), (idx[:4093], 3),
                         (idx[:7], 5), (idx[:1], 1)] if name_ in chains else [])
        for p_, sample in sets:
            a = rng.chain_uniforms(root, p_.contiguous(), sample, **kw)
            b_ = rng.chain_uniforms_plain(root, p_.contiguous(), sample, **kw)
            if not torch.equal(a.view(torch.int32), b_.view(torch.int32)):
                raise SystemExit(f"keyed_chain_uniforms ({name_}) disagrees with its plain "
                                 f"version on {p_.numel()} lanes, sample {sample}")
            err_chain = max(err_chain, float((a - b_).abs().max()))
            n_cases += 1
    sync()
    log("rng", f"keyed_chain_uniforms vs plain: {n_cases} cases ({', '.join(shapes)}) on "
        f"{CHUNK}, 4,093, 7 and 1 lanes with indices up to 2**32 - 1, samples 0, 3, 2**31 + 1 "
        f"(and the first six on {N_LANES} lanes, samples 0 and 2**31 + 1): equal bit for bit")
    pix_c = idx[10:10 + CHUNK].contiguous()
    lib = native.kernel_lib("rng.cu")
    timed = {}
    for name_ in ("nested blocks", "VPL picks", "AO directions", "bounce block"):
        kw = shapes[name_]
        tags = rng._chain_tags(kw.get("chain", ()))
        n = kw.get("n", 1)
        groups = math.prod(c for _, c in tags)
        width, n_u = kw.get("lead", 0) + groups * n, groups * n
        folds = keyed_key_hashes(CHUNK, "chain", **kw)[0] // CHUNK - 2
        plain = cuda_ms(lambda: rng.chain_uniforms_plain(root, pix_c, 1, **kw), n=5, warm=1)
        bound = timing.bound_ms(
            CHUNK * (8 + 4 * width), f32_ops=CHUNK * n_u,
            i32_ops=CHUNK * (OPS_AO_LANE_KEY + folds * OPS_CHAIN_GROUP_TAG
                             + n_u * (OPS_PER_UNIFORM + 2)))
        timed[name_] = dict(plain=plain, bound=bound, **keyed_tile_timed(
            f"keyed_chain_uniforms ({name_}: {groups} groups x {n} uniforms, {width} columns, "
            f"{folds} fold-ins a lane) on {CHUNK} lanes (plain {plain:.3f} ms)",
            lambda: rng.chain_uniforms(root, pix_c, 1, **kw), lib, "keyed_chain_uniforms_kernel",
            rng.chain_tiling(CHUNK, tags, n, kw.get("lead", 0), rng.sm_count(dev)), CHUNK * n_u,
            keyed_key_hashes(CHUNK, "chain", **kw), bound, RNG_ROUNDS,
            fused=n == 1 or not rng.chain_tiling(CHUNK, tags, n, kw.get("lead", 0))[4]))
    tq_a = timed["nested blocks"]

    # ---- (e) 16² references ----------------------------------------------
    for kind, directive in PREPROCESS_REF.items():
        t16 = TINY_SCENE.replace('"path" "integer maxdepth" [5]', directive).replace(
            "WorldEnd", SUBSURFACE_BOXES + SUBSURFACE_ROOM + "WorldEnd")
        card_vs_cpu(f"tiny room with subsurface boxes, {kind}", t16, spp=1, chunk_pixels=256,
                    bin_tol=REF_BIN_REL_CAMERAS)
    log("preprocess", f"phase 15 took {time.time() - t_phase:.1f} s")
    return [
        dict(name="mo_gather", route="cuda", source="pbrt_torch/csrc/dipole.cu",
             replaces="pbrt_tpu/integrators/dipole.py:187", launches=mo_launches,
             max_abs_err=max(r["err"] for r in mo_rows.values()), ms=mo_main["tq"]["ms"],
             plain_ms=mo_main["plain_ms"], bound_ms=mo_main["bound"], bound_by=mo_main["by"],
             library_ms=None),
        dict(name="keyed_chain_uniforms", route="cuda", source="pbrt_torch/csrc/rng.cu",
             replaces="pbrt_tpu/integrators/path.py:115", launches=chain_launches,
             max_abs_err=err_chain, ms=tq_a["ms"], plain_ms=tq_a["plain"],
             bound_ms=tq_a["bound"][0], bound_by=tq_a["bound"][1], library_ms=None),
    ]


# ---------------------------------------------------------------------------
# phase 16: PRT, probes and the Metropolis renderer
# ---------------------------------------------------------------------------

#: the Metropolis renderer on killeroo-simple at its golden's 256² film:
#: 16,384 chains × 8 iterations (2 mutations per pixel; 32 iterations
#: through PR 15, cut to keep the script inside its limit)
MLT_RENDERER = 'Renderer "metropolis" "integer samplesperpixel" [2]'
#: the probe grid's spacing in killeroo's 1,400 × 2,000 × 1,140 room
PROBE_SPACING = 250
#: the mutation kernel's shapes: bidirectional MLT at depth 5 (16,384 × 60),
#: the ragged ones, and the bootstrap's large-only block
MUTATE_SHAPES = ((16384, 60), (1, 60), (7, 1), (4093, 61), (4093, 1), (7, 61), (16384, 40),
                 (4093, 65), (4093, 40))
BOOTSTRAP_SHAPE = (100000, 60)
#: the large-only mode's other shapes: the PRT projection's and the probes'
#: directions, and ragged totals at 1 and 4 counters a thread
FLAT_SHAPES = ((4096, 2), (100001, 7), (100003, 11), (1, 3))
#: u values at the mutation wrap's edges and outside [0, 1) (fmodf's range)
MUTATE_WRAP_EDGES = (0.0, 1.0 - 2**-24, 2**-24, 1 / 16, 1 - 1 / 16, 1 / 1024, 0.5, -0.5, 1.5,
                     2.0, -1.0, 3.25, -3.25, -0.0, 1.0, 0.0625 + 2**-24, 0.9375 - 2**-24)
#: per small-step element, float32 operations: the exponent's product, expf
#: (counted 8), s2 ·, the sign's product and the sum, fmodf (counted 4) and
#: the wrap's compare and add
OPS_MUTATE_SMALL_F32 = 1 + 8 + 1 + 2 + 4 + 2
#: per chain, the large-step compare
OPS_MUTATE_CHAIN_F32 = 1


def _device_threefry_counter(rng_mod):
    """A stand-in for ``rng.threefry2x32`` that counts its calls on CUDA
    tensors (the torch-op threefry on the card) and on the host apart; →
    (function, counts)."""
    import torch

    counts = {"card": 0, "host": 0}
    real = rng_mod.threefry2x32

    def counted(k0, k1, x0, x1):
        on_card = any(torch.is_tensor(v) and v.is_cuda for v in (k0, k1, x0, x1))
        counts["card" if on_card else "host"] += 1
        return real(k0, k1, x0, x1)

    return counted, counts


def _profile_step(label, step, step_ms, what="one iteration"):
    """One MLT iteration (or ``what`` else ``step`` runs) under the
    profiler: kernel time, launches, busy share against its unprofiled
    ``step_ms`` and the traversal's share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a first kernel for the tracer to start on: the step's own first
        # launch (the mutation) was missing from the trace without it
        torch.ones(1, device="cuda").add_(1)
        step()
        torch.cuda.synchronize()
    kern = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_ms = sum(k[1] for k in kern)
    n = sum(k[2] for k in kern)
    trav = sum(k[1] for k in kern if "traverse_" in k[0])
    mut = sum(k[1] for k in kern if "mlt_mutate" in k[0])
    log("profile", f"{label}: {what}, kernel time {dev_ms:.2f} ms in {n} launches (one "
        f"of them the tracer's first) = "
        f"{100 * dev_ms / step_ms:.1f}% of the unprofiled {step_ms:.1f} ms (device idle the "
        f"rest); traversal {trav:.3f} ms ({100 * trav / max(dev_ms, 1e-9):.1f}%), mlt_mutate "
        f"{mut:.4f} ms")
    for k, ms_, cnt in sorted(kern, key=lambda x: -x[1])[:6]:
        log("profile", f"  {ms_:8.2f} ms  {cnt:6d}x  {k[:90]}")
    return dict(ms=dev_ms, launches=n, traversal_ms=trav)


def prt_mlt_phase(dev, data_dir, drive, profile_frame, card_vs_cpu, agree):
    """Phase 16: killeroo-simple under the Metropolis renderer
    (bidirectional, and unidirectional with ``path``), under ``diffuseprt``
    and ``glossyprt``, ``Renderer "createprobes"`` and ``useprobes``
    reading its file; the mutation kernel against its plain version and
    timed; the 16² references. → the kernels line's entry."""
    import torch

    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.core import rng
    from pbrt_torch.integrators import bdpt
    from pbrt_torch.renderers import metropolis as tm
    from pbrt_torch.renderers import probes
    from pbrt_torch.renderers.dispatch import render_scene
    from pbrt_torch.scene import builder
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build
    from pbrt_torch.utils import native
    from pbrt_torch.utils.timing import cuda_ms

    sync = torch.cuda.synchronize
    t_phase = time.time()
    text, _ = real_scene_text(res=256)
    t0 = time.time()
    base = build(load_scene_string(text), device=dev)
    log("scene", f"killeroo-simple at 256x256 built in {time.time() - t0:.1f} s "
        f"(world bound {base.scene.geometry.world_lo.tolist()} - "
        f"{base.scene.geometry.world_hi.tolist()})")

    def variant(integrator=None, renderer=None):
        """The base build with another integrator or renderer, its
        preprocess run with threefry's torch ops counted: none."""
        t_ = text
        if integrator:
            t_ = t_.replace('SurfaceIntegrator "directlighting"', f"SurfaceIntegrator {integrator}")
        if renderer:
            t_ = t_.replace("WorldBegin", renderer + "\nWorldBegin", 1)
        desc = load_scene_string(t_)
        b = dataclasses.replace(
            base, renderer_name=desc.renderer[0], renderer_params=desc.renderer[1],
            integrator=builder._integrator_config(*desc.surface_integrator,
                                                  base.film_config.n_bins))
        t1 = time.time()
        with mock.patch.object(rng, "threefry2x32", wraps=rng.threefry2x32) as tf:
            b = builder.preprocess(b, desc.surface_integrator[1])
            sync()
        if tf.call_count:
            raise SystemExit(f"{integrator or renderer}: the preprocess ran threefry in torch "
                             "ops")
        return b, time.time() - t1

    # ---- (a) the mutation kernel against its plain version ---------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    rng.reset_launches()
    n_cases, err_mut = 0, 0.0
    edges = torch.tensor(MUTATE_WRAP_EDGES, dtype=torch.float32, device=dev)
    for N, D in MUTATE_SHAPES:
        u = torch.rand((N, D), generator=gen, device=dev)
        n_e = min(N * D, edges.numel())
        u.view(-1)[:n_e] = edges[:n_e]
        for it, p_large in ((0, 0.25), (31, 0.25), (7, 1.0), (2**20, 0.0)):
            keys = rng.mutate_keys(rng.fold_in(rng.root_key(N), 1000 + it))
            k_ = rng.mutate(u, keys, p_large)
            p_ = rng.mutate_plain(u, keys, p_large)
            if not (torch.equal(k_[0].view(torch.int32), p_[0].view(torch.int32))
                    and torch.equal(k_[1], p_[1])
                    and torch.equal(k_[2].view(torch.int32), p_[2].view(torch.int32))):
                raise SystemExit(f"mlt_mutate disagrees with mutate_plain on {N} x {D}, "
                                 f"p_large {p_large}")
            err_mut = max(err_mut, float((k_[0] - p_[0]).abs().max()))
            n_cases += 1
    kb = rng.fold_in(rng.root_key(0), tm.BOOTSTRAP_TAG)
    for n, d in (BOOTSTRAP_SHAPE,) + FLAT_SHAPES:
        fb = rng.flat_uniforms(kb, n, d, dev)
        if not torch.equal(fb.view(torch.int32),
                           rng.flat_uniforms_plain(kb, n, d, dev).view(torch.int32)):
            raise SystemExit(f"mlt_mutate's large-only mode disagrees with flat_uniforms_plain "
                             f"on {n} x {d}")
    sync()
    log("rng", f"mlt_mutate vs mutate_plain: {n_cases} cases ({MUTATE_SHAPES} chains x "
        f"dimensions, u at the wrap's edges and outside [0, 1), large-step probabilities .25, "
        f"1, 0): u', is_large and the accept uniforms equal bit for bit; its large-only mode on "
        f"the bootstrap's {BOOTSTRAP_SHAPE[0]} x {BOOTSTRAP_SHAPE[1]} and on {FLAT_SHAPES} (1 "
        f"and 4 counters a thread): equal bit for bit")
    lib = native.kernel_lib("rng.cu")
    timed_m = {}
    for label in MUTATE_TIMED:
        case = rng_timed_case(label, dev)
        timed_m[label] = dict(case=case, **rng_case_timed(case, lib))
    tq = timed_m["16,384 x 60, p_large .25"]
    plain_ms = cuda_ms(tq["case"]["plain"], n=3, warm=1)
    m_bound, m_by = tq["bound_ms"], tq["bound_by"]

    # ---- (b) killeroo under the Metropolis renderer ----------------------
    mlt_launches = 0
    counted, tf_counts = _device_threefry_counter(rng)
    for label, integ, renderer in (
            ("bidirectional", None, MLT_RENDERER),
            ("unidirectional, path depth 5", '"path" "integer maxdepth" [5]',
             MLT_RENDERER + ' "bool bidirectional" ["false"]')):
        b, _ = variant(integ, renderer)
        tc.reset_launches()
        rng.reset_launches()
        stats = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with mock.patch.object(rng, "threefry2x32", counted):
            ev[0].record()
            film = tm.render_metropolis(b, seed=0, stats=stats)
            ev[1].record()
            sync()
        sec = ev[0].elapsed_time(ev[1]) / 1e3
        launches = {**tc.launches, **rng.launches}
        n_mut = 16384 * stats["iterations"]
        finite = bool(torch.isfinite(film.pixels).all())
        total = float(film.pixels.double().sum())
        log("render", f"killeroo-simple, Metropolis {label}, 256x256, {stats['dims']} "
            f"dimensions, 16384 chains x {stats['iterations']} iterations: {sec:.3f} s "
            f"(bootstrap {stats['bootstrap_s']:.3f} s, chains {stats['chains_s']:.3f} s), "
            f"b {stats['b']:.6g}, {n_mut / stats['chains_s']:.1f} mutations/s, acceptance "
            f"{stats['acceptance']:.4f}, film finite {finite}, sum {total:.6g}; launches "
            f"{launches}; threefry torch ops on the card {tf_counts['card']} (host key "
            f"derivations {tf_counts['host']})")
        if not (finite and total > 0.0):
            raise SystemExit(f"Metropolis {label}: the film is not finite, or black")
        if (launches["mlt_mutate"] != stats["iterations"] + 1 or tf_counts["card"]
                or not launches["traverse_closest"] or not launches["traverse_any"]):
            raise SystemExit(f"Metropolis {label}: not one mutation launch per iteration and "
                             "one for the bootstrap, threefry on the card, or no traversal")
        mlt_launches += launches["mlt_mutate"]
        st, opts = stats["state"], stats["options"]
        step = lambda: tm.mlt_step(b, st, stats["iterations"], opts)
        ev[0].record()
        step()
        ev[1].record()
        sync()
        _profile_step(f"killeroo-simple, Metropolis {label}", step, ev[0].elapsed_time(ev[1]))

    # ---- (c) killeroo under diffuseprt and glossyprt --------------------
    for kind in ("diffuseprt", "glossyprt"):
        b, pre_s = variant(f'"{kind}"')
        c0 = b.scene.prt.c_in[0]
        log("scene", f"killeroo-simple with {kind}: lmax {b.scene.prt.lmax}, projection of "
            f"4096 rays in {pre_s:.2f} s, {b.integrator.prt_nsamples} samples per hit; c_in's "
            f"first band: mean {float(c0.mean()):.6g}, bins 0/16/31 {float(c0[0]):.6g} "
            f"{float(c0[16]):.6g} {float(c0[31]):.6g}")
        if not (b.integrator.prt_nsamples == 64 and float(c0.min()) > 0
                and bool(torch.isfinite(b.scene.prt.c_in).all())):
            raise SystemExit(f"killeroo-simple with {kind}: the projection failed")
        _, sec, _, _ = drive(f"killeroo-simple with {kind}", b, 1, warm=False)
        profile_frame(f"killeroo-simple with {kind}, chunk 0", b, sec * 1e3,
                      run=chunk_wave(b, dev), scale=chunks_of(b))

    # ---- (d) createprobes, then useprobes reading its file --------------
    pfile = os.path.join(data_dir, "killeroo.probes")
    b, _ = variant(renderer=f'Renderer "createprobes" "float samplespacing" [{PROBE_SPACING}] '
                            f'"string filename" ["{pfile}"]')
    t0 = time.time()
    with mock.patch.object(rng, "threefry2x32", wraps=rng.threefry2x32) as tf:
        out = render_scene(b)
        sync()
    lmax, lo, hi, grid, coeffs = probes.read_probe_file(pfile, 32)
    log("probes", f"Renderer \"createprobes\" (samplespacing {PROBE_SPACING}) on killeroo: "
        f"{grid} probes x 256 directions, lmax {lmax}, written in {time.time() - t0:.2f} s "
        f"to a {os.path.getsize(pfile)}-byte file and read back ({coeffs.shape}, finite "
        f"{bool(np.isfinite(coeffs).all())}, l=0 mean {float(coeffs[:, 0].mean()):.6g}); "
        f"threefry torch ops {tf.call_count}")
    if (out != [pfile] or tf.call_count or not np.isfinite(coeffs).all()
            or coeffs.shape[0] != int(np.prod(grid)) or not coeffs[:, 0].max() > 0):
        raise SystemExit("createprobes: no file, threefry in torch ops, or a bad grid")
    b, _ = variant(f'"useprobes" "string filename" ["{pfile}"]')
    if b.integrator.kind != "useprobes" or b.scene.probes is None:
        raise SystemExit("useprobes did not read the probe file")
    _, sec, _, _ = drive("killeroo-simple with useprobes", b, 1, warm=False)
    profile_frame("killeroo-simple with useprobes, chunk 0", b, sec * 1e3,
                  run=chunk_wave(b, dev), scale=chunks_of(b))
    del b, base

    # ---- (e) 16² references ----------------------------------------------
    for kind in ("diffuseprt", "glossyprt"):
        card_vs_cpu(f"tiny scene, {kind}", TINY_SCENE.replace(
            '"path" "integer maxdepth" [5]', f'"{kind}" "integer nsamples" [16]'),
            spp=1, chunk_pixels=256, bin_tol=REF_BIN_REL_CAMERAS)
    files = []
    for d in (dev, "cpu"):
        f = os.path.join(data_dir, f"tiny-{torch.device(d).type}.probes")
        probes.create_probes(build(load_scene_string(TINY_SCENE), device=d), lmax=4,
                             nprobes=(2, 2, 2), nindir=32, filename=f)
        files.append((f, probes.read_probe_file(f, 32)))
    (f_card, a_), (_, b_) = files
    same = np.isclose(a_[4], b_[4], rtol=REF_RTOL, atol=REF_ATOL).all(-1).mean()
    frame_eq = (a_[0] == b_[0] and a_[3] == b_[3] and np.array_equal(a_[1], b_[1])
                and np.array_equal(a_[2], b_[2]))
    log("reference", f"tiny scene's {a_[3]} probe file, made on the card and on the CPU: "
        f"(probe, term) rows close (rtol {REF_RTOL:g}) {same:.4f}, lmax, bound and grid "
        f"equal {frame_eq}")
    if same < REF_PIXELS or not frame_eq or a_[3] != (2, 2, 2):
        raise SystemExit("the probe files of the card and the CPU disagree")
    card_vs_cpu("tiny scene, useprobes (the card's file)", TINY_SCENE.replace(
        '"path" "integer maxdepth" [5]', f'"useprobes" "string filename" ["{f_card}"]'),
        spp=1, chunk_pixels=256, bin_tol=REF_BIN_REL_CAMERAS)
    # trace_bidir per lane, and one MLT step, from one shared state
    pair = [build(load_scene_string(TINY_SCENE.replace(
        "WorldBegin", 'Renderer "metropolis" "integer samplesperpixel" [4]\nWorldBegin', 1)),
        device=d) for d in (dev, "cpu")]
    D = bdpt.n_dims_bidir(pair[0].integrator.max_depth)
    u_np = np.random.default_rng(16).random((256, D), dtype=np.float32)
    per_lane = []
    for b in pair:
        u_ = torch.as_tensor(u_np, device=b.device)
        rays = b.camera.generate_rays(u_[:, 0] * 16, u_[:, 1] * 16, u_[:, 2], u_[:, 3], u_[:, 4])
        per_lane.append(bdpt.trace_bidir(b.scene, rays, b.integrator, u_)[0].cpu().numpy())
    agree("tiny scene, trace_bidir per lane on one shared array (lanes as 16x16), card vs CPU",
          per_lane[0].reshape(1, 16, 16, -1), per_lane[1].reshape(1, 16, 16, -1),
          REF_BIN_REL_CAMERAS)
    opts = tm.MLTOptions.of(pair[1])
    idx = torch.arange(256)
    L, I, px, py = tm._eval_paths(pair[1], torch.as_tensor(u_np), idx, True, 0)
    states = [tm.ChainState(*(x.to(b.device) for x in (torch.as_tensor(u_np), L, I, px, py)),
                            splat=torch.zeros((16, 16, 32), device=b.device),
                            accepted=torch.zeros((), dtype=torch.int64, device=b.device))
              for b in pair]
    keys = rng.mutate_keys(rng.fold_in(rng.root_key(0), tm.ITERATION_TAG + 3))
    u_new_cpu, _, u_acc = rng.mutate_plain(states[1].u, keys, opts.p_large)
    u_acc = u_acc.numpy()
    _, I_new, _, _ = tm._eval_paths(pair[1], u_new_cpu, idx, True, 0)
    a = torch.clamp(I_new / torch.clamp(I, min=1e-12), 0.0, 1.0).numpy()
    for b, st in zip(pair, states):
        tm.mlt_step(b, st, 3, opts)
    acc = [(st.u.cpu() != torch.as_tensor(u_np)).any(-1).numpy() for st in states]
    near = np.abs(u_acc - a) < 1e-5
    log("reference", f"tiny scene, one Metropolis step of 256 chains from one shared state, "
        f"card vs CPU: accepted {int(acc[0].sum())} / {int(acc[1].sum())}, decisions equal "
        f"{bool(np.array_equal(acc[0][~near], acc[1][~near]))} on the {int((~near).sum())} "
        f"lanes with |u_acc - a| >= 1e-5 ({int(near.sum())} near the threshold, logged: "
        f"{np.nonzero(near)[0].tolist()})")
    if not np.array_equal(acc[0][~near], acc[1][~near]):
        raise SystemExit("one Metropolis step: the card and the CPU accept differently")
    agree("tiny scene, one Metropolis step's splat, card vs CPU",
          states[0].splat.cpu().numpy()[None], states[1].splat.numpy()[None],
          REF_BIN_REL_CAMERAS)
    log("prt_mlt", f"phase 16 took {time.time() - t_phase:.1f} s")
    return dict(name="mlt_mutate", route="cuda", source="pbrt_torch/csrc/rng.cu",
                replaces="pbrt_tpu/renderers/metropolis.py:73", launches=mlt_launches,
                max_abs_err=err_mut, ms=tq["ms"], plain_ms=plain_ms, bound_ms=m_bound,
                bound_by=m_by, library_ms=None)


# ---------------------------------------------------------------------------
# phase 17: differentiable rendering, resume, the sharded renderer, tools
# ---------------------------------------------------------------------------

#: central differences (the JAX test's rule): kd bins at depth 4, where
#: Russian roulette (bounce > 3) does not act, the emit bin at depth 5
FD_KD_BINS = (0, 15, 31)
FD_EMIT_BIN = 16
FD_EPS = 1e-3
FD_RTOL = 5e-2
#: the tiny scene's gradients, card against CPU: the largest difference
#: within this share of the CPU's largest gradient, per leaf (the 16²
#: references' per-bin rule, REF_BIN_REL_CAMERAS, carried to the sums a
#: gradient is: a lane the two libm's send apart moves both alike)
GRAD_REF_REL = 5e-3
#: kernels against plain walks on one chunk of the gradient path
GRAD_PLAIN_RTOL = 1e-5


def frame_inputs(b):
    """Wave 0 (seed 0) of ``b``'s film in ``CHUNK``-lane chunks: the camera
    rays and the primary-sample array, one ``keyed_uniforms`` launch per
    chunk."""
    import torch

    from pbrt_torch.renderers import sampler as sm

    xs, ys, pix, mask, root, scr = sm.pixel_chunks(b, 0, CHUNK)
    if not bool(mask.all()):
        raise ValueError("the gradient path takes a film of whole chunks")
    ic = b.integrator
    u = torch.cat([sm.wave_uniforms(ic, root, pix[c], scr[c], 0, b.sampler_name, 1)
                   for c in range(xs.shape[0])])
    rays = b.camera.generate_rays(xs.reshape(-1).float() + u[:, 0],
                                  ys.reshape(-1).float() + u[:, 1], u[:, 2], u[:, 3], u[:, 4])
    return rays, u


def grad_phase(dev, data_dir, name, smi):
    """Phase 17: the gradient path (``integrators/grad.py``) on
    killeroo-simple at 512², ``path`` depth 5, and ``goldens/metal.pbrt``'s
    texture table; central differences; kernels against plain walks on one
    chunk; the tiny scene's gradients card vs CPU; a resumed render; the
    sharded renderer in an ``nccl`` group of one; ``exrdiff`` and
    ``datdiff`` on its outputs. → the gradient runs' launches per kernel."""
    import torch
    import torch.distributed as dist

    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.core import rng
    from pbrt_torch.film import film as film_mod
    from pbrt_torch.film.imageio import write_exr
    from pbrt_torch.integrators import grad as tgrad
    from pbrt_torch.integrators import path as tpath
    from pbrt_torch.parallel import shard
    from pbrt_torch.renderers.sampler import render
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build
    from pbrt_torch import tools

    sync = torch.cuda.synchronize
    t_phase = time.time()
    on_card = f"on {name} ({smi})"
    text, _ = real_scene_text()
    t0 = time.time()
    b0 = build(load_scene_string(text), device=dev)
    b = dataclasses.replace(b0, integrator=dataclasses.replace(b0.integrator, kind="path",
                                                               max_depth=5))
    del b0
    g, ic = b.scene.geometry, b.integrator
    R = b.film_config.xres * b.film_config.yres
    S = b.film_config.n_bins
    log("grad", f"killeroo-simple at 512x512, path depth 5: built in {time.time() - t0:.1f} s; "
        f"{R} camera paths in {R // CHUNK} chunks of {CHUNK}; leaves kd "
        f"{tuple(b.scene.materials.kd.shape)}, emit {tuple(b.scene.lights.emit.shape)}")
    watched = ("traverse_closest", "traverse_any", "keyed_uniforms", "keyed_scrambles")

    def counts():
        return {k: {**tc.launches, **rng.launches}[k] for k in watched}

    def run_grads(label, bb, fn):
        """``fn(scene, rays, uniforms, cfg, chunk=CHUNK)`` with its inputs
        drawn first, counted (launches per pass, threefry torch ops on the
        card), timed per pass with the peak memory of each pass-2 chunk."""
        st = {"pass2": None, "snap": None, "base": 0, "peaks": []}
        real = tgrad.trace_radiance

        def traced(*a, **k):
            if torch.is_grad_enabled():
                sync()
                if st["pass2"] is None:
                    st["pass2"], st["snap"] = time.time(), counts()
                    st["base"] = torch.cuda.memory_allocated()
                else:
                    st["peaks"].append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
            return real(*a, **k)

        tc.reset_launches()
        rng.reset_launches()
        counted, tf = _device_threefry_counter(rng)
        sync()
        t_start = time.time()
        with mock.patch.object(tgrad, "trace_radiance", traced), \
                mock.patch.object(rng, "threefry2x32", counted):
            rays, u = frame_inputs(bb)
            out = fn(bb.scene, rays, u, bb.integrator, chunk=CHUNK)
            sync()
        t_end = time.time()
        st["peaks"].append(torch.cuda.max_memory_allocated())
        end = counts()
        n = rays.origin.shape[0]
        nc = n // CHUNK
        p1 = {k: st["snap"][k] / nc for k in watched}
        p2 = {k: (end[k] - st["snap"][k]) / nc for k in watched}
        sec1, sec2 = st["pass2"] - t_start, t_end - st["pass2"]
        log("grad", f"{label}: {t_end - t_start:.3f} s (inputs and pass 1 {sec1:.3f} s, pass 2 "
            f"{sec2:.3f} s), {n / (t_end - t_start):.1f} gradient paths/s {on_card}; launches "
            f"per chunk, pass 1 (with the inputs) {p1}, pass 2 {p2}; pass 2's peak memory per "
            f"chunk {[round(x / 2**30, 3) for x in st['peaks']]} GiB over "
            f"{st['base'] / 2**30:.3f} GiB held before it; threefry torch ops {tf}")
        if tf["card"]:
            raise SystemExit(f"{label}: threefry ran in torch ops on the card")
        if end["traverse_closest"] == 0 or end["keyed_uniforms"] != nc:
            raise SystemExit(f"{label}: the gradient path did not launch the traversal and "
                             "keyed kernels")
        return out, rays, u, dict(sec=t_end - t_start, end=end)

    # ---- the forward pass alone, then the gradients ------------------------
    rays, u = frame_inputs(b)
    sync()
    t0 = time.time()
    fwd_loss = float(tgrad.radiance_loss(b.scene, rays, u, ic, chunk=CHUNK))
    sync()
    fwd_sec = time.time() - t0
    log("grad", f"forward (radiance_loss, no graph): {fwd_sec:.3f} s, {R / fwd_sec:.1f} camera "
        f"paths/s {on_card}; loss {fwd_loss:.9g}")
    (loss, gv), rays, u, vg = run_grads("value_and_grads (kd, emit)", b, tgrad.value_and_grads)
    gm, _, _, gmat = run_grads("grad_wrt_materials (kd, ks, kr, kt)", b,
                               tgrad.grad_wrt_materials)
    launched = dict(vg["end"])
    for k in watched:
        launched[k] += gmat["end"][k]
    log("grad", f"gradient paths/s against forward paths/s: {R / vg['sec']:.1f} / "
        f"{R / fwd_sec:.1f} ({fwd_sec / vg['sec']:.3f}x); loss {float(loss):.9g} (forward "
        f"{fwd_loss:.9g}, equal {float(loss) == fwd_loss})")
    row = int(g.tri_material[4])  # the first blob's material (4 wall triangles first)
    finite = all(bool(torch.isfinite(x).all()) for x in (*gv.values(), *gm.values()))
    log("grad", f"finite {finite}; |d loss/d kd| of the killeroo row {row} max "
        f"{float(gv['kd'][row].abs().max()):.6g}, of every row "
        f"{[round(float(x), 9) for x in gv['kd'].abs().amax(1)]}; |d loss/d emit| max "
        f"{float(gv['emit'].abs().max()):.6g}; ks, kr, kt max "
        f"{[round(float(gm[k].abs().max()), 9) for k in ('ks', 'kr', 'kt')]}")
    if not (finite and float(gv["kd"][row].abs().max()) > 0
            and float(gv["emit"][0].abs().max()) > 0 and float(loss) == fwd_loss):
        raise SystemExit("the gradients are not finite, vanish, or the loss differs from the "
                         "forward pass")

    # ---- central differences ----------------------------------------------
    def loss64(scene, cfg):
        tot = torch.zeros((), dtype=torch.float64, device=dev)
        with torch.no_grad():
            for a in range(0, R, CHUNK):
                L = tpath.trace_radiance(scene, tgrad._ray_rows(rays, a, a + CHUNK), cfg,
                                         u[a:a + CHUNK])[0]
                tot += L.double().sum()
        return float(tot) / (R * S)

    def central(name_, x0, r_, b_, cfg):
        xp, xm = x0.clone(), x0.clone()
        xp[r_, b_] += FD_EPS
        xm[r_, b_] -= FD_EPS
        # the step the float32 parameters took (emit ~2,000: eps is ~8 ulps)
        step = float(xp[r_, b_]) - float(xm[r_, b_])
        return (loss64(tgrad._with_params(b.scene, {name_: xp}), cfg)
                - loss64(tgrad._with_params(b.scene, {name_: xm}), cfg)) / step

    t0 = time.time()
    ic4 = dataclasses.replace(ic, max_depth=4)
    _, g4 = tgrad.value_and_grads(b.scene, rays, u, ic4, chunk=CHUNK)
    fd_ok = True
    for name_, grads, r_, bins, cfg, checked in (
            ("kd", g4["kd"], row, FD_KD_BINS, ic4, True),
            ("emit", gv["emit"], 0, (FD_EMIT_BIN,), ic, True),
            ("kd", gv["kd"], row, (15,), ic, False)):
        x0 = b.scene.materials.kd if name_ == "kd" else b.scene.lights.emit
        for b_ in bins:
            fd = central(name_, x0, r_, b_, cfg)
            an = float(grads[r_, b_])
            ok = fd != 0.0 and abs(an - fd) <= FD_RTOL * abs(fd) + 1e-7
            fd_ok &= ok or not checked
            log("grad", f"central difference, {name_}[{r_}, {b_}] at depth {cfg.max_depth}: "
                f"gradient {an:.6g}, difference {fd:.6g}, rel {abs(an - fd) / max(abs(fd), 1e-30):.4g}"
                + (f" (rtol {FD_RTOL:g}: {ok})" if checked else
                   " (logged: roulette's survival moves with kd, the detached gradient does not)"))
    log("grad", f"central differences took {time.time() - t0:.1f} s")
    if not fd_ok:
        raise SystemExit("a gradient disagrees with its central difference")

    # ---- one chunk: kernels against plain walks; profiled -------------------
    one = (tgrad._ray_rows(rays, 0, CHUNK), u[:CHUNK])
    _, gk = tgrad.value_and_grads(b.scene, *one, ic)
    before = dict(tc.launches)
    plain = lambda *a, fmad=False, **kw: tc.traverse_plain(*a, **kw)
    with mock.patch.object(tc, "traverse", plain):
        _, gp = tgrad.value_and_grads(b.scene, *one, ic)
    sync()
    rel = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max().clamp(min=1e-30))
           for k in gk}
    log("grad", f"chunk 0 ({CHUNK} lanes), kernels vs plain walks on the card: max abs diff "
        f"over max |g| {rel} (rtol {GRAD_PLAIN_RTOL:g}); kernel launches during the plain run "
        f"{sum(tc.launches[k] - before[k] for k in before)}")
    if any(v > GRAD_PLAIN_RTOL for v in rel.values()) or tc.launches != before:
        raise SystemExit("the gradients through the kernels differ from the plain walks'")
    dL = torch.full((CHUNK, S), 1.0 / (R * S), device=dev)

    def chunk_pass2():
        leaves = [b.scene.materials.kd.detach().requires_grad_(),
                  b.scene.lights.emit.detach().requires_grad_()]
        sc = tgrad._with_params(b.scene, {"kd": leaves[0], "emit": leaves[1]})
        L = tpath.trace_radiance(sc, one[0], ic, one[1])[0]
        torch.autograd.grad(L, leaves, grad_outputs=dL)

    chunk_pass2()
    sync()
    t0 = time.time()
    chunk_pass2()
    sync()
    _profile_step("killeroo-simple, the gradient path", chunk_pass2, (time.time() - t0) * 1e3,
                  what="one chunk of pass 2 (forward with its graph, backward)")
    del gk, gp, g4, gm, rays, u

    # ---- the tiny scene, card against CPU --------------------------------------
    got = []
    for device in (dev, "cpu"):
        bt = build(load_scene_string(TINY_SCENE), device=device)
        rt, ut = frame_inputs(bt)
        lt_, gt_ = tgrad.value_and_grads(bt.scene, rt, ut, bt.integrator, chunk=100)
        got.append((float(lt_), {k: v.cpu() for k, v in gt_.items()}))
    (lc, gc), (lp, gpc) = got
    ref = {k: float((gc[k] - gpc[k]).abs().max() / gpc[k].abs().max()) for k in gc}
    log("grad", f"tiny scene 16x16, path depth 5, chunks of 100: loss card {lc:.9g} CPU "
        f"{lp:.9g}; max |card - CPU| over the CPU's max |g| {ref} (rule {GRAD_REF_REL:g}: "
        "the 16² references' per-bin rule for the radiance, carried to its sums)")
    if any(v > GRAD_REF_REL for v in ref.values()) or abs(lc - lp) > GRAD_REF_REL * lp:
        raise SystemExit("the tiny scene's gradients on the card differ from the CPU's")

    # ---- goldens/metal.pbrt's texture table ---------------------------------
    write_texture_data(data_dir)
    metal_path = os.path.join(data_dir, "metal.pbrt")
    shutil.copy(os.path.join(HERE, "goldens", "metal.pbrt"), metal_path)
    bm = load_checked(metal_path, dev, "goldens/metal.pbrt")
    gtex, _, _, _ = run_grads("metal.pbrt 256x256, grad_wrt_textures (pool_rgb, c1)", bm,
                              tgrad.grad_wrt_textures)
    tex_fin = all(bool(torch.isfinite(x).all()) for x in gtex.values())
    log("grad", f"metal.pbrt: finite {tex_fin}; pool_rgb {tuple(gtex['pool_rgb'].shape)}, "
        f"{int((gtex['pool_rgb'] != 0).any(1).sum())} texels with a gradient, max "
        f"{float(gtex['pool_rgb'].abs().max()):.6g}; c1 max {float(gtex['c1'].abs().max()):.6g}")
    if not (tex_fin and float(gtex["pool_rgb"].abs().max()) > 0):
        raise SystemExit("metal.pbrt's texture gradients are not finite or vanish")
    del bm, gtex

    # ---- resume ---------------------------------------------------------------
    br = build(load_scene_string(real_scene_text(res=128)[0]), device=dev)
    paths = {k: os.path.join(data_dir, f"{k}.npz") for k in ("full", "resumed")}
    t0 = time.time()
    full = render(br, spp=4, checkpoint_path=paths["full"], checkpoint_every=2)
    sync()
    t1 = time.time()
    render(br, spp=2, checkpoint_path=paths["resumed"], checkpoint_every=2)
    sync()
    t2 = time.time()
    resumed = render(br, spp=4, checkpoint_path=paths["resumed"], checkpoint_every=2)
    sync()
    t3 = time.time()
    no_ck = render(br, spp=4)
    same = all(torch.equal(getattr(full, k), getattr(resumed, k)) for k in shard.FILM_FIELDS)
    gap = float((resumed.pixels - no_ck.pixels).abs().max())
    log("resume", f"killeroo 128x128, directlighting, 4 spp, checkpoint every 2: uninterrupted "
        f"{t1 - t0:.3f} s, 2 waves into the checkpoint {t2 - t1:.3f} s, resumed to 4 "
        f"{t3 - t2:.3f} s {on_card}; resumed equal bit for bit {same}; against no checkpoint "
        f"max abs diff {gap:.3g} (atol 1e-6)")
    if not (same and gap <= 1e-6 and float(full.pixels.sum()) > 0):
        raise SystemExit("the resumed render differs from the uninterrupted one")

    # ---- the sharded renderer in an nccl group of one -------------------------
    bs = build(load_scene_string(real_scene_text(res=256)[0]), device=dev)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    rank, world = shard.init_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        backend = dist.get_backend()
        sync()
        t0 = time.time()
        fs = shard.render_sharded(bs, spp=1)
        sync()
        t1 = time.time()
    finally:
        dist.destroy_process_group()
    fr = render(bs, spp=1)
    sync()
    t2 = time.time()
    w_eq = bool(torch.equal(fs.weight, fr.weight))
    px_rel = float(((fs.pixels - fr.pixels).abs() / fr.pixels.abs().clamp(min=1e-30)).max())
    log("shard", f"killeroo 256x256, 1 spp: render_sharded in a {backend} group of {world} "
        f"(rank {rank}) {t1 - t0:.3f} s, render {t2 - t1:.3f} s {on_card}; weights equal "
        f"{w_eq}, pixels max rel diff {px_rel:.3g} (rtol 1e-6: the merge's film + (out - film))")
    if not (w_eq and px_rel <= 1e-6 and backend == "nccl" and world == 1):
        raise SystemExit("the sharded render differs from render's")

    # ---- tools on the phase's outputs ------------------------------------------
    files = {}
    for k, f_ in (("full", full), ("resumed", resumed), ("one_spp", render(br, spp=1))):
        files[k] = write_exr(os.path.join(data_dir, f"{k}.exr"), film_mod.to_rgb_image(f_))
    for k, f_ in (("sharded", fs), ("render", fr)):
        files[k] = film_mod.write_dat(f_, bs.film_config, os.path.join(data_dir, f"{k}.dat"))
    rcs = {"exrdiff resumed full": tools.main(["exrdiff", files["resumed"], files["full"]]),
           "exrdiff resumed 1-spp": tools.main(["exrdiff", files["resumed"], files["one_spp"]]),
           "datdiff sharded render": tools.main(["datdiff", files["sharded"], files["render"]])}
    log("tools", f"exit codes {rcs} (expected 0, 1, 0)")
    if list(rcs.values()) != [0, 1, 0]:
        raise SystemExit("a tool's exit code is not the expected one")
    log("grad", f"phase 17 took {time.time() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 18: volumes under the cache, MLT and the gradients; AO under MLT
# ---------------------------------------------------------------------------

#: phase 18's frames: killeroo-simple in phase 13's fog (emission) at 256²
#: (the cache, MLT, igi's gradient) and at 512² (the path gradient)
FOG_RES, FOG_GRAD_RES = 256, 512
#: its Metropolis renderer: 2 mutations per pixel (16,384 chains × 8
#: iterations at 256²) from a bootstrap of 32,768 vectors (one chunk)
FOG_MLT = ('Renderer "metropolis" "integer samplesperpixel" [2] '
           '"integer bootstrapsamples" [32768]')
#: its central difference: kd bin 15 of the killeroo row at depth 4 (no
#: roulette), the rule of phase 17
FOG_FD_BIN = 15
#: the kernels whose launches the phase adds to the kernels line
FOG_COUNTED = ("traverse_closest", "traverse_any", "keyed_uniforms", "keyed_scrambles",
               "keyed_volume_uniforms", "keyed_chain_uniforms", "mlt_mutate")


def fog_tiny_text(directive: str, integrator: str = "emission", renderer: str = "") -> str:
    """The tiny scene under ``directive`` (and ``renderer``) in the 16²
    references' homogeneous fog under the volume ``integrator``."""
    text = TINY_SCENE.replace('"path" "integer maxdepth" [5]', directive)
    if renderer:
        text = text.replace("WorldBegin", renderer + "\nWorldBegin", 1)
    return media_scene_text(text, REF_VOLUMES["homogeneous"], integrator)


def fog_phase(dev, drive, profile_frame, card_vs_cpu, agree, name, smi):
    """Phase 18: killeroo-simple in a fog under the irradiance cache, the
    Metropolis renderer (bidirectional, unidirectional under ``path`` and
    under ``ambientocclusion``) and the gradients (``path`` at 512² with a
    central difference, ``igi``); the tiny scene's fog references, card
    against CPU, under each. → the phase's launches per counted kernel."""
    import torch

    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.core import rng
    from pbrt_torch.integrators import bdpt
    from pbrt_torch.integrators import grad as tgrad
    from pbrt_torch.renderers import metropolis as tm
    from pbrt_torch.renderers import sampler as sm
    from pbrt_torch.scene import builder
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    sync = torch.cuda.synchronize
    t_phase = time.time()
    on_card = f"on {name} ({smi})"
    total = dict.fromkeys(FOG_COUNTED, 0)

    def counted():
        return {k: {**tc.launches, **rng.launches}[k] for k in FOG_COUNTED}

    def reset():
        tc.reset_launches()
        rng.reset_launches()

    def add(launches):
        for k in FOG_COUNTED:
            total[k] += launches[k]

    fog_text = media_scene_text(real_scene_text(res=FOG_RES)[0], FOG_VOLUME, "emission")
    t0 = time.time()
    base = build(load_scene_string(fog_text), device=dev)
    if not base.scene.has_volumes:
        raise SystemExit("the fog scene has no volume")
    log("fog", f"killeroo-simple at {FOG_RES}x{FOG_RES} in the fog built in "
        f"{time.time() - t0:.1f} s")

    def variant(integrator=None, renderer=None, text=fog_text, b0=None):
        """``b0`` (the base build) with another integrator or renderer, its
        preprocess run with threefry's torch ops counted: none."""
        t_ = text
        if integrator:
            t_ = t_.replace('SurfaceIntegrator "directlighting"', f"SurfaceIntegrator {integrator}")
        if renderer:
            t_ = t_.replace("WorldBegin", renderer + "\nWorldBegin", 1)
        desc = load_scene_string(t_)
        b_ = dataclasses.replace(
            b0 or base, renderer_name=desc.renderer[0], renderer_params=desc.renderer[1],
            integrator=builder._integrator_config(*desc.surface_integrator,
                                                  base.film_config.n_bins,
                                                  desc.volume_integrator[0]))
        with mock.patch.object(rng, "threefry2x32", wraps=rng.threefry2x32) as tf:
            b_ = builder.preprocess(b_, desc.surface_integrator[1])
            sync()
        if tf.call_count:
            raise SystemExit(f"{integrator or renderer}: the preprocess ran threefry in torch "
                             "ops")
        return b_

    # ---- (a) the irradiance cache in the fog -------------------------------
    b = variant('"irradiancecache" "integer maxdepth" [5]')
    film, sec, lk, _ = drive("killeroo-simple in fog, irradiancecache", b, 1, warm=False)
    add(lk)
    log("fog", f"irradiancecache in the fog: keyed_chain_uniforms {lk['keyed_chain_uniforms']} "
        f"({lk['keyed_chain_uniforms'] // chunks_of(b)} per chunk: both passes' directions, "
        f"nested blocks and nested jitters), keyed_volume_uniforms "
        f"{lk['keyed_volume_uniforms']} (the top trace's)")
    profile_frame("killeroo-simple in fog, irradiancecache, chunk 0", b, sec * 1e3,
                  run=chunk_wave(b, dev), scale=chunks_of(b))

    # ---- (b) the Metropolis renderer in the fog, and AO under MLT -----------
    threefry, tf_counts = _device_threefry_counter(rng)
    for label, integ, renderer in (
            ("bidirectional", None, FOG_MLT),
            ("unidirectional, path depth 5", '"path" "integer maxdepth" [5]',
             FOG_MLT + ' "bool bidirectional" ["false"]'),
            ("unidirectional, ambientocclusion", '"ambientocclusion" "integer nsamples" [4]',
             FOG_MLT + ' "bool bidirectional" ["false"]')):
        b = variant(integ, renderer)
        reset()
        stats = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with mock.patch.object(rng, "threefry2x32", threefry):
            ev[0].record()
            film = tm.render_metropolis(b, seed=0, stats=stats)
            ev[1].record()
            sync()
        sec = ev[0].elapsed_time(ev[1]) / 1e3
        lk = counted()
        add(lk)
        n_evals = 1 + 1 + stats["iterations"]  # bootstrap chunk, the chains' start, steps
        n_mut = tm.N_CHAINS * stats["iterations"]
        finite = bool(torch.isfinite(film.pixels).all())
        s_ = float(film.pixels.double().sum())
        log("render", f"killeroo-simple in fog, Metropolis {label}, {FOG_RES}x{FOG_RES}, "
            f"{stats['dims']} dimensions, {tm.N_CHAINS} chains x {stats['iterations']} "
            f"iterations: {sec:.3f} s (bootstrap {stats['bootstrap_s']:.3f} s, chains "
            f"{stats['chains_s']:.3f} s), {n_mut / stats['chains_s']:.1f} mutations/s "
            f"{on_card}, b {stats['b']:.6g}, acceptance {stats['acceptance']:.4f}; launches "
            f"{lk} ({n_evals} path evaluations: per evaluation closest "
            f"{lk['traverse_closest'] / n_evals:.1f}, any {lk['traverse_any'] / n_evals:.1f}); "
            f"threefry torch ops on the card {tf_counts['card']}; film finite {finite}, "
            f"sum {s_:.6g}")
        ao = b.integrator.kind == "ambientocclusion"
        want_media = 0 if ao else n_evals  # the chains' media block per evaluation
        want_chain = n_evals if ao else 0  # AO's directions from the chains' keys
        if not (finite and s_ > 0.0) or tf_counts["card"]:
            raise SystemExit(f"fog, Metropolis {label}: the film is not finite or black, or "
                             "threefry ran in torch ops on the card")
        if (lk["mlt_mutate"] != stats["iterations"] + 1 or not lk["traverse_closest"]
                or lk["keyed_volume_uniforms"] != want_media
                or lk["keyed_chain_uniforms"] != want_chain):
            raise SystemExit(f"fog, Metropolis {label}: not one mutation per iteration, no "
                             "traversal, or the keyed draws not once per evaluation")

    # ---- (c) the gradients in the fog ---------------------------------------
    def fog_inputs(bb):
        """Wave 0 (seed 0) of ``bb``: rays, the primary-sample array (one
        keyed_uniforms launch per chunk), the media block and the
        integrator's draws (one launch each for the frame)."""
        xs, ys, pix, mask, root, scr = sm.pixel_chunks(bb, 0, CHUNK)
        rays, u = frame_inputs(bb)
        flat = pix.reshape(-1).contiguous()
        return rays, u, dict(media=sm.media_uniforms(bb.scene, bb.integrator, root, flat, 0),
                             draws=sm.integrator_draws(bb.scene, bb.integrator, root, flat, 0))

    def grads(label, bb, ic=None):
        """``value_and_grads`` (kd, emit) of wave 0 in ``CHUNK``-lane chunks,
        its inputs drawn first, timed and counted."""
        ic = ic or bb.integrator
        reset()
        with mock.patch.object(rng, "threefry2x32", threefry):
            sync()
            t0 = time.time()
            rays, u, kw = fog_inputs(bb)
            loss, g = tgrad.value_and_grads(bb.scene, rays, u, ic, chunk=CHUNK, **kw)
            sync()
            sec = time.time() - t0
        lk = counted()
        add(lk)
        R = rays.origin.shape[0]
        nc = R // CHUNK
        finite = all(bool(torch.isfinite(x).all()) for x in g.values())
        log("grad", f"{label}: {sec:.3f} s, {R / sec:.1f} gradient paths/s {on_card}; "
            f"launches per chunk (both passes, the inputs' with them) "
            f"{ {k: round(v / nc, 2) for k, v in lk.items()} }; threefry torch ops on the "
            f"card {tf_counts['card']}; loss {float(loss):.9g}; finite {finite}, |d/d kd| "
            f"max {float(g['kd'].abs().max()):.6g}, |d/d emit| max "
            f"{float(g['emit'].abs().max()):.6g}")
        if (tf_counts["card"] or not finite or not float(g["kd"].abs().max()) > 0
                or not float(g["emit"].abs().max()) > 0 or not lk["traverse_closest"]
                or lk["keyed_volume_uniforms"] != 1):
            raise SystemExit(f"{label}: threefry on the card, gradients not finite or "
                             "vanishing, or no traversal / media launch")
        return loss, g, rays, u, kw

    big = media_scene_text(real_scene_text(res=FOG_GRAD_RES)[0], FOG_VOLUME, "emission")
    bg = variant('"path" "integer maxdepth" [5]', text=big,
                 b0=build(load_scene_string(big), device=dev))
    ic = bg.integrator
    loss, gv, rays, u, kw = grads(f"killeroo-simple in fog {FOG_GRAD_RES}x{FOG_GRAD_RES}, "
                                  "path depth 5, value_and_grads (kd, emit)", bg)
    sync()
    t0 = time.time()
    fwd = float(tgrad.radiance_loss(bg.scene, rays, u, ic, chunk=CHUNK, **kw))
    sync()
    R = rays.origin.shape[0]
    log("grad", f"forward (radiance_loss) in the fog: {time.time() - t0:.3f} s, "
        f"{R / (time.time() - t0):.1f} camera paths/s; loss {fwd:.9g}, equal to the "
        f"gradient's {fwd == float(loss)}")
    if fwd != float(loss):
        raise SystemExit("the fog's gradient loss differs from its forward pass")
    row = int(bg.scene.geometry.tri_material[4])
    ic4 = dataclasses.replace(ic, max_depth=4)
    _, g4, _, _, _ = grads("the same at depth 4", bg, ic4)
    kd = bg.scene.materials.kd

    def loss64(x):
        scene = tgrad._with_params(bg.scene, {"kd": x})
        tot = torch.zeros((), dtype=torch.float64, device=dev)
        with torch.no_grad():
            for a in range(0, R, CHUNK):
                tot += tgrad._traced(scene, rays, u, ic4, kw["media"], None, a,
                                     a + CHUNK).double().sum()
        return float(tot) / (R * kd.shape[1])

    xp, xm = kd.clone(), kd.clone()
    xp[row, FOG_FD_BIN] += FD_EPS
    xm[row, FOG_FD_BIN] -= FD_EPS
    fd = (loss64(xp) - loss64(xm)) / (float(xp[row, FOG_FD_BIN]) - float(xm[row, FOG_FD_BIN]))
    an = float(g4["kd"][row, FOG_FD_BIN])
    ok = fd != 0.0 and abs(an - fd) <= FD_RTOL * abs(fd) + 1e-7
    log("grad", f"central difference in the fog, kd[{row}, {FOG_FD_BIN}] at depth 4: gradient "
        f"{an:.6g}, difference {fd:.6g}, rel {abs(an - fd) / max(abs(fd), 1e-30):.4g} "
        f"(rtol {FD_RTOL:g}: {ok})")
    if not ok:
        raise SystemExit("the fog's gradient disagrees with its central difference")
    del bg, gv, g4, rays, u, kw
    bi = variant('"igi" "integer maxdepth" [5]')
    _, gi, _, _, kwi = grads(f"killeroo-simple in fog {FOG_RES}x{FOG_RES}, igi depth 5, "
                             "value_and_grads (kd, emit)", bi)
    if kwi["draws"] is None or total["keyed_chain_uniforms"] == 0:
        raise SystemExit("igi's gradient drew no VPL picks")
    del bi, gi, base

    # ---- (d) 16² references: the tiny scene in the fog, card vs CPU --------
    for integrator in ("emission", "single"):
        card_vs_cpu(f"tiny scene in fog ({integrator})", fog_tiny_text(
            '"irradiancecache" "integer maxdepth" [2]', integrator), spp=1, chunk_pixels=256,
            bin_tol=REF_BIN_REL_CAMERAS)
    for label, directive, bidir in (
            ("bidirectional", '"path" "integer maxdepth" [5]', True),
            ("unidirectional path", '"path" "integer maxdepth" [5]', False),
            ("unidirectional ambientocclusion", '"ambientocclusion" "integer nsamples" [4]',
             False)):
        pair = [build(load_scene_string(fog_tiny_text(directive, "single", 'Renderer '
                                                      '"metropolis"')), device=d)
                for d in (dev, "cpu")]
        D = tm.n_dims(pair[1], bidir)
        u_np = np.random.default_rng(18).random((256, D), dtype=np.float32)
        per_lane = [tm._eval_paths(b_, torch.as_tensor(u_np, device=b_.device),
                                   torch.arange(256, device=b_.device), bidir, 0)[0]
                    .cpu().numpy().reshape(1, 16, 16, -1) for b_ in pair]
        agree(f"tiny scene in fog (single), Metropolis {label}: the path evaluation of 256 "
              "chains on one shared array (lanes as 16x16), card vs CPU", *per_lane,
              REF_BIN_REL_CAMERAS)
    got = []
    for directive in ('"path" "integer maxdepth" [5]', '"igi" "integer maxdepth" [3]'):
        for d in (dev, "cpu"):
            bt = build(load_scene_string(fog_tiny_text(directive, "single")), device=d)
            rt, ut, kt = fog_inputs(bt)
            lt_, gt_ = tgrad.value_and_grads(bt.scene, rt, ut, bt.integrator, chunk=128, **kt)
            got.append((float(lt_), {k: v.cpu() for k, v in gt_.items()}))
        (lc, gc), (lp, gp) = got[-2:]
        ref = {k: float((gc[k] - gp[k]).abs().max() / gp[k].abs().max()) for k in gc}
        log("grad", f"tiny scene in fog (single) 16x16, {directive}, chunks of 128: loss card "
            f"{lc:.9g} CPU {lp:.9g}; max |card - CPU| over the CPU's max |g| {ref} (rule "
            f"{GRAD_REF_REL:g})")
        if any(v > GRAD_REF_REL for v in ref.values()) or abs(lc - lp) > GRAD_REF_REL * lp:
            raise SystemExit(f"the fog's gradients on the card differ from the CPU's "
                             f"({directive})")
    log("fog", f"phase 18 took {time.time() - t_phase:.1f} s; its launches {total}")
    return total


def chunk_wave(b, dev):
    """Chunk 0's wave of sample 0 of ``b`` (seed 3), its keyed arrays drawn
    first (the camera columns of its sampler, a lens camera's noise, the
    media block, the integrator's draws); → a callable that renders it. A
    512² frame's profile takes this wave, scaled by the chunks: processing
    a whole frame's ~140,000 profiler events takes tens of seconds."""
    from pbrt_torch.film import film as film_mod
    from pbrt_torch.renderers import sampler as sampler_mod

    xs, ys, pix, mask, root, scr = sampler_mod.pixel_chunks(b, 3, CHUNK)
    ic = b.integrator
    u = sampler_mod.wave_uniforms(ic, root, pix[0], scr[0], 0, b.sampler_name, 1)
    kw = dict(noise=sampler_mod.camera_noise(b.camera, root, pix[0], 0),
              media=sampler_mod.media_uniforms(b.scene, ic, root, pix[0], 0),
              draws=sampler_mod.integrator_draws(b.scene, ic, root, pix[0], 0))
    st = film_mod.init_film(b.film_config, dev)
    return lambda: sampler_mod.render_wave(st, b.scene, b.camera, b.filter_table, xs[0],
                                           ys[0], ic, b.film_config, u, sample_scale=mask[0],
                                           **kw)


_T0 = time.time()


def log(phase, msg):
    print(f"[{phase}] {msg} (+{time.time() - _T0:.1f} s)", flush=True)


def step_summary(steps, ms=None):
    """Steps per lane of one launch's lanes (the plain version's
    ``lane_steps``): their spread, the per-warp maximum at 32 rays per warp
    (one thread per ray) and at 4 (8 lanes per ray), and the share of
    lane-steps that do work; with the kernel's ms, ms per step of the
    longest ray."""
    import torch

    s = steps.double()
    out = dict(mean=float(s.mean()), p99=float(torch.quantile(s, 0.99)),
               max=int(steps.max()))
    for rays in (32, 4):
        w = s.view(-1, rays).max(1).values
        out[f"warp{rays}_mean"] = float(w.mean())
        out[f"warp{rays}_max"] = int(w.max())
        out[f"use{rays}"] = float(s.sum() / (rays * w.sum()))
    if ms is not None:
        out["ms_per_longest_step"] = ms / max(int(steps.max()), 1)
    return out


def _sass_functions(lib_path: str) -> dict:
    """{function name: [(address, predicate, opcode, operands)]} of a
    library's SASS (cuobjdump, beside nvcc)."""
    import re
    import subprocess

    from pbrt_torch.utils import native

    tool = os.path.join(os.path.dirname(native.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in re.split(r"\n\s+Function : ", text)[1:]:
        head, body = part.split("\n", 1)
        # a branch target printed as a label: its address instead
        labels = {m.group(1): m.group(2) for m in re.finditer(
            r"(\.L_x_\d+):\s*\n\s*/\*([0-9a-f]+)\*/", body)}
        body = re.sub(r"`\((\.L_x_\d+)\)", lambda m: "0x" + labels.get(m.group(1), "0"), body)
        out[head.strip()] = [
            (int(a, 16), pred, op, rest) for a, pred, op, rest in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
    return out


def sass_per_hash(lib_path: str):
    """{kernel: (instructions, hashes, {opcode: count per hash})} of the
    keyed kernels in a library's SASS (cuobjdump, beside nvcc). Each
    inlined threefry hash has exactly 20 funnel-shift rotations, so the
    SHF.L.W count / 20 is the number of hashes; the per-hash counts are the
    kernel's divided by it (the rest of the kernel included, a few per
    cent)."""
    import re

    out = {}
    for head, ins in _sass_functions(lib_path).items():
        # a templated kernel's instance: its sampler code, from the mangled
        # name's template argument (ILi<code>E)
        name = re.search(r"keyed_\w+?_kernel(?:ILi\d+E)?", head)
        ops = [x[2] for x in ins]
        hashes = sum(o.startswith("SHF.L.W") for o in ops) / 20
        if name and hashes:
            per = {k: sum(o.split(".")[0] == k for o in ops) / hashes
                   for k in ("SHF", "LOP3", "IADD3", "IMAD")}
            per["IMAD.IADD"] = sum(o == "IMAD.IADD" for o in ops) / hashes
            out[re.sub(r"ILi(\d+)E", r"<\1>", name.group(0))] = (len(ops), hashes, per)
    return out


#: the SASS opcode classes ``sass_loop_stats`` counts
SASS_KINDS = {"instructions": lambda op: True, "MUFU": lambda op: op.startswith("MUFU"),
              "LDS": lambda op: op.startswith("LDS"),
              "LDL+STL": lambda op: op.startswith(("LDL", "STL")),
              "BRA": lambda op: op.startswith("BRA"), "BAR": lambda op: op.startswith("BAR")}


def sass_loop_stats(lib_path: str, kernel: str, inner_trips: int = 1) -> dict:
    """SASS counts of ``kernel`` (a substring of its name) in a library,
    per (lane, point) of the Mo gather: the innermost loop that holds
    expf's MUFU.EX2 (two per (lane, point) it computes), plus, when
    ``inner_trips`` > 1, the part of its enclosing loop outside the loops
    it holds (run once per ``inner_trips`` inner iterations; a second
    inner loop, run only in a slow case, is left out). A loop is a backward branch
    (``BRA`` to a lower address) and the code between its target and it.
    Two counts of each opcode class (``SASS_KINDS``): every instruction of
    the loop (``static``), and those a lane issues when no sqrtf or divide
    takes its slow path (``issued``: less the few instructions a predicated
    forward branch skips that ``CALL`` the slow path). → dict of
    static and issued {class: per (lane, point)}, the loop's and the outer
    part's sizes and the kernel's instructions."""
    import re

    fns = [v for k, v in _sass_functions(lib_path).items() if kernel in k]
    if len(fns) != 1:
        raise SystemExit(f"sass_loop_stats: {len(fns)} functions named like {kernel}")
    ins = fns[0]
    target = lambda rest: int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16)
    branches = [(a, pred, target(rest)) for a, pred, op, rest in ins
                if op.startswith("BRA") and re.search(r"0x[0-9a-f]+", rest)]
    slow = set()
    for a, pred, t in branches:
        skipped = [x for x in ins if a < x[0] < t]
        if pred and t > a and len(skipped) <= 8 and any(x[2].startswith("CALL")
                                                        for x in skipped):
            slow.update(x[0] for x in skipped)
    loops = {(t, a) for a, _, t in branches if t < a}
    loops = sorted(([x for x in ins if t <= x[0] <= a] for t, a in loops), key=len)
    loops = [lp for lp in loops if any(x[2].startswith("MUFU.EX2") for x in lp)]
    if not loops:
        raise SystemExit(f"sass_loop_stats: no loop of {kernel} holds MUFU.EX2")
    inner = loops[0]
    per = sum(x[2].startswith("MUFU.EX2") for x in inner) / 2
    around = [lp for lp in loops if len(lp) > len(inner) and lp[0][0] <= inner[0][0]
              and lp[-1][0] >= inner[-1][0]]
    # the enclosing loop less every loop inside it (the inner one, and
    # another that only a slow case runs)
    nested = [lp for lp in loops if around and lp is not around[0]
              and around[0][0][0] <= lp[0][0] and lp[-1][0] <= around[0][-1][0]]
    outer = ([x for x in around[0] if not any(lp[0][0] <= x[0] <= lp[-1][0] for lp in nested)]
             if inner_trips > 1 and around else [])
    out = dict(loop=len(inner), outer=len(outer), total=len(ins))
    for name, keep in (("static", lambda x: True), ("issued", lambda x: x[0] not in slow)):
        out[name] = {k: sum(f(x[2]) for x in inner if keep(x)) / per
                     + sum(f(x[2]) for x in outer if keep(x)) / (per * inner_trips)
                     for k, f in SASS_KINDS.items()}
    return out


#: SASS opcode classes by the pipe they issue to (the integer ALU: shifts,
#: logic, 3-input adds, compares, selects; the FMA pipe: integer multiply-adds
#: and float arithmetic; shared and global memory)
_ALU_OPS = ("SHF", "LOP3", "IADD3", "ISETP", "SEL", "LEA", "PRMT", "IABS", "VIADD", "IMNMX",
            "FSEL")
_FMA_OPS = ("IMAD", "FADD", "FMUL", "FFMA")
SASS_PIPES = {
    "ALU": lambda op: op.split(".")[0] in _ALU_OPS,
    "FMA": lambda op: op.split(".")[0] in _FMA_OPS,
    "LDS": lambda op: op.startswith("LDS"), "STG": lambda op: op.startswith("STG"),
    "other": lambda op: op.split(".")[0] not in _ALU_OPS + _FMA_OPS + ("LDS", "STG"),
}


def keyed_tile_sass(lib_path: str, kernel: str) -> dict:
    """SASS counts of a tiled keyed kernel (``kernel`` a substring of its
    name: ``keyed_volume_uniforms_kernel``, ``keyed_chain_uniforms_kernel``),
    from its innermost loops (a backward ``BRA`` and the code between its
    target and it), a hash counted by its 20 rotations (SHF.L.W; a
    narrow group's uniforms share one key schedule): ``elem``, per element
    of the element loop
    (of the loops that store to global memory, STG, one hash a store, the
    one with the most stores: its instructions over its stores), with its
    instructions by pipe (``elem_pipes``, ``SASS_PIPES``), or None where
    the kernel has none; ``fused``, per hash of the loop that derives a
    narrow group's key and hashes its uniforms (one hash more than its
    stores: its instructions over its hashes); ``key``, per hash of the key
    loops (the loops that hash and store to shared memory, STS, not to
    global memory: their instructions over their hashes)."""
    import re

    fns = [v for k, v in _sass_functions(lib_path).items() if kernel in k]
    if len(fns) != 1:
        raise SystemExit(f"keyed_tile_sass: {len(fns)} functions named like {kernel}")
    ins = fns[0]
    loops = [(int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16), a) for a, _, op, rest in ins
             if op.startswith("BRA") and re.search(r"0x[0-9a-f]+", rest)]
    loops = [(t, a) for t, a in loops if t < a]
    inner = [(t, a) for t, a in loops
             if not any((t2, a2) != (t, a) and t <= t2 and a2 <= a for t2, a2 in loops)]
    count = lambda body, f: sum(f(x[2]) for x in body)
    elem = fused = None
    key = [0, 0]
    for t, a in inner:
        body = [x for x in ins if t <= x[0] <= a]
        stg = count(body, lambda op: op.startswith("STG"))
        sts = count(body, lambda op: op.startswith("STS"))
        hashes = count(body, lambda op: op.startswith("SHF.L.W")) // 20
        if stg and hashes == stg and (elem is None or stg > elem[1]):
            elem = (len(body), stg, {k: count(body, f) for k, f in SASS_PIPES.items()})
        elif stg and hashes == stg + 1:
            fused = len(body) / hashes
        elif sts and hashes and not stg:
            key[0] += len(body)
            key[1] += hashes
    if fused is None or not key[1]:
        raise SystemExit(f"keyed_tile_sass: no fused loop or key loop in {kernel}: innermost "
                         f"loops (instructions, STG, STS, hashes) " + str([
                             (len(b), count(b, lambda op: op.startswith("STG")),
                              count(b, lambda op: op.startswith("STS")),
                              count(b, lambda op: op.startswith("SHF.L.W")) // 20)
                             for b in ([x for x in ins if t <= x[0] <= a] for t, a in inner)]))
    return dict(elem=elem[0] / elem[1] if elem else None, fused=fused,
                elem_pipes={k: v / elem[1] for k, v in elem[2].items()} if elem else None,
                key=key[0] / key[1], total=len(ins))


def keyed_issue_ms(sass: dict, uniforms: int, key_hashes: tuple, fused: bool, mhz: float,
                   sms: int) -> float:
    """A tiled keyed launch's issue-slot bound: its loops' SASS (``keyed_tile_sass``)
    for its uniforms and key hashes ((all, of them the group keys'),
    ``keyed_key_hashes``), a warp instruction per 32 threads, over ``sms``
    × 4 schedulers at ``mhz``: where its groups are narrow (``fused``) the
    uniforms and group keys at the fused loop's per hash, else the uniforms
    at the element loop's and the group keys at the key loops'."""
    every, group = key_hashes
    if fused:
        return (issue_bound_ms(uniforms + group, 1, sass["fused"] / 32, mhz, sms)
                + issue_bound_ms(every - group, 1, sass["key"] / 32, mhz, sms))
    return (issue_bound_ms(uniforms, 1, sass["elem"] / 32, mhz, sms)
            + issue_bound_ms(every, 1, sass["key"] / 32, mhz, sms))


def keyed_tile_timed(label: str, fn, lib, kernel: str, tiling, elements: int, key_hashes: tuple,
                     bound, rounds: int = 5, fused: bool = False) -> dict:
    """``fn`` (a launch of a tiled keyed kernel) timed by ``timing.queued_rounds``
    with ``nvidia-smi``'s SM clock sampled meanwhile, beside its bound
    ``bound`` ((ms, by)) and its issue-slot bound: the element loop's SASS
    per element × ``elements`` plus the key loops' SASS per hash ×
    ``key_hashes``, a warp instruction per 32 threads, over 132 × 4
    schedulers at the clock read (``keyed_tile_sass``); with the kernel's
    registers (ptxas) and blocks per SM at the launch's staged keys. Logs a
    line; → dict of it all."""
    import torch

    from pbrt_torch.core import rng
    from pbrt_torch.utils import native, timing

    sass = keyed_tile_sass(lib._name, kernel)
    t = [int(w) for w in tiling]
    ran = kernel if t[4] else kernel.replace("_uniforms_kernel", "_rows_kernel")  # keyed_rows
    regs = next((v for f, v in kernel_registers(lib._name, native.build_log.get("pbrt_torch_rng"))
                 .items() if ran in f), None)
    smem = 8 * t[1] * (1 + t[8] + t[11]) if t[4] else 0  # keyed_rows stages no key
    blocks = blocks_per_sm(regs, smem, t[3]) if regs else None
    with SmClock() as clk:
        tq = timing.queued_rounds(fn, rounds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = keyed_issue_ms(sass, elements, key_hashes, fused, clk.mhz, sms) if clk.mhz else None
    out = dict(label=label, ms=tq["ms"], min=tq["min"], max=tq["max"], host_ms=tq["host_ms"],
               bound_ms=bound[0], bound_by=bound[1], issue_bound_ms=issue, sm_mhz=clk.mhz,
               sass=sass, registers=regs, smem_bytes=smem, blocks_per_sm=blocks,
               tile_rows=t[1], tile_cols=t[5], threads=t[3], pass_rows=t[4])
    log("timing", f"{label}: median {tq['ms']:.5f} ms over {rounds} rounds ({tq['min']:.5f}–"
        f"{tq['max']:.5f}; host enqueue {tq['host_ms']:.4f} ms); bound {bound[0]:.5f} ms "
        f"({bound[1]}), kernel / bound {tq['ms'] / bound[0]:.2f}x; issue-slot bound "
        + (f"{issue:.5f} ms ({elements} uniforms, {key_hashes[0]} key hashes, "
           f"{key_hashes[1]} of them group keys; SASS a hash: "
           + (f"{sass['fused']:.1f} with a narrow group's key" if fused else
              f"{sass['elem']:.1f} a uniform, {sass['key']:.1f} a group key")
           + f", {sass['key']:.1f} a lane or outer key; at {clk.mhz:g} MHz), kernel / issue "
           f"bound {tq['ms'] / issue:.2f}x" if issue else "not measured (no SM clock read)")
        + f"; {regs} registers, tiles of {t[1]} rows x {t[5]} columns, {t[4]} rows a pass, "
        f"{smem} B of keys, {blocks} blocks of {t[3]} threads per SM")
    return out


def keyed_key_hashes(R: int, kind: str, **kw) -> tuple:
    """The hashes a tiled keyed launch spends on keys, (all, the group
    keys'): per row the lane key (2), its outer keys' fold-ins (volume:
    bounce 0's VOLUME key where ``single``; chain: the outer tags once per
    outer key) and its group keys' (volume: one per jitter and step; chain:
    the last tag once per group)."""
    from pbrt_torch.core import rng

    if kind == "volume":
        group = kw["n_jitter"] + rng.VOLUME_STEPS * kw["single"]
        return R * (2 + kw["single"] + group), R * group
    tags = rng._chain_tags(kw.get("chain", ()))
    G = math.prod(c for _, c in tags)
    outers = G // tags[-1][1] if tags else 1
    group = G if tags else 0
    return R * (2 + outers * max(len(tags) - 1, 0) + group), R * group


#: the mutation kernel's timed shapes: label → (chains, dimensions,
#: p_large), or ("flat", n, d) for its large-only mode (the bootstrap's
#: block; the PRT projection's and the probes' directions)
MUTATE_TIMED = {
    "16,384 x 60, p_large .25": (16384, 60, 0.25),
    "16,384 x 60, p_large 1": (16384, 60, 1.0),
    "16,384 x 60, p_large 0": (16384, 60, 0.0),
    "16,384 x 40, p_large .25": (16384, 40, 0.25),
    "large-only 100,000 x 60": ("flat", 100000, 60),
    "large-only 4,096 x 2": ("flat", 4096, 2),
}
#: the normals' timed shapes: label → (lanes, tags)
NORMALS_TIMED = {
    "32,768 x 11": (32768, 11),
    "32,768 x 1": (32768, 1),
    "4,096 x 11": (4096, 11),
}


def sass_hash_loops(lib_path: str, kernel: str) -> dict:
    """SASS of one kernel function (``kernel`` a substring of its name):
    each loop (a backward ``BRA`` and the code between its target and it)
    less the loops inside it, and the code outside every loop (``rest``)
    and the whole function (``total``), each as instructions (``n``),
    hashes (``hashes``: its SHF.L.W rotations / 20), ``STG``, ``STS`` and
    ``EX2`` (MUFU.EX2, expf's) counts."""
    import re

    fns = [v for k, v in _sass_functions(lib_path).items() if kernel in k]
    if len(fns) != 1:
        raise SystemExit(f"sass_hash_loops: {len(fns)} functions named like {kernel}")
    ins = fns[0]
    spans = sorted({(int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16), a)
                    for a, _, op, rest in ins
                    if op.startswith("BRA") and re.search(r"0x[0-9a-f]+", rest)})
    spans = [(t, a) for t, a in spans if t < a]

    def stats(body):
        has = lambda pre: sum(x[2].startswith(pre) for x in body)
        return dict(n=len(body), hashes=has("SHF.L.W") / 20, STG=has("STG"), STS=has("STS"),
                    EX2=has("MUFU.EX2"))

    loops = []
    for t, a in spans:
        inner = [(t2, a2) for t2, a2 in spans if (t2, a2) != (t, a) and t <= t2 and a2 <= a]
        loops.append(stats([x for x in ins if t <= x[0] <= a
                            and not any(t2 <= x[0] <= a2 for t2, a2 in inner)]))
    return dict(loops=loops, total=stats(ins),
                rest=stats([x for x in ins if not any(t <= x[0] <= a for t, a in spans)]))


def rng_timed_case(label: str, dev) -> dict:
    """A timed shape of ``mlt_mutate`` or ``keyed_camera_normals``
    (``MUTATE_TIMED``, ``NORMALS_TIMED``) on ``dev``, its inputs from a
    seed: ``run(mod)`` launches it through a module's wrappers (this tree's
    ``rng``, or an earlier tree's), ``equal(out)`` holds a launch's outputs
    to the plain version's bit for bit, ``plain()`` runs the plain version;
    its bound (ms, by), the kernel function and block it runs (``kernel``,
    ``threads``, ``smem``) and ``issue(lib_path, mhz, sms)``, its issue-slot
    bound: the thread-hashes it needs at the new build's SASS a hash (from
    ``sass_hash_loops``), a warp instruction per 32 threads, over ``sms`` × 4
    schedulers at ``mhz``."""
    import torch

    from pbrt_torch.core import rng
    from pbrt_torch.utils import timing

    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    same = lambda a, b: all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b, strict=True))
    per_hash = lambda loop: loop["n"] / loop["hashes"]
    warp_ms = lambda warp_ins, mhz, sms: warp_ins / 32 / (sms * 4 * mhz * 1e6) * 1e3
    sms = rng.sm_count(dev)
    if label in NORMALS_TIMED:
        R, T = NORMALS_TIMED[label]
        root, pix = rng.root_key(0), torch.arange(R, dtype=torch.int64, device=dev)
        tag0 = rng.IDEAL_NOISE_TAG if T == 1 else rng.REALISTIC_NOISE_TAG
        ref = rng.camera_normals_plain(root, pix, 1, tag0, T)
        hashes = R * (2 + 3 * T)
        if T == 1:  # the row kernel: a thread a row
            threads, smem, kernel = rng.NORMAL_ROW_THREADS, 0, "keyed_camera_normals_rows_kernel"
        else:  # a band's lane keys staged, then a thread `items` (row, tag) items
            band, threads, items = (int(w) for w in rng.normals_launch(R, T, sms)[:3])
            smem, kernel = 8 * band, f"keyed_camera_normals_kernelILi{items}E"

        def issue(lib_path, mhz, sms_):
            sass = sass_hash_loops(lib_path, kernel)
            if T == 1:  # straight-line code: every thread runs it once
                return warp_ms(R * sass["total"]["n"], mhz, sms_)
            item = next(lp for lp in sass["loops"] if lp["STG"])  # an iteration: `items` items
            key = next(lp for lp in sass["loops"] if lp["STS"])  # an iteration: two rows
            return warp_ms(-(-R * T // items) * item["n"] + -(-R // 2) * key["n"], mhz, sms_)

        return dict(label=label, kind="normals", lanes=R,
                    run=lambda mod: (mod.camera_normals(root, pix, 1, tag0, T),),
                    equal=lambda o: same(o, (ref,)),
                    plain=lambda: rng.camera_normals_plain(root, pix, 1, tag0, T),
                    bound=timing.bound_ms(
                        R * (8 + 4 * 2 * T), f32_ops=R * T * 2 * OPS_NORMAL_F32,
                        i32_ops=R * (OPS_NORMALS_LANE_KEY + T * OPS_PER_NORMAL_TAG)),
                    kernel=kernel, threads=threads, smem=smem, issue=issue,
                    work=f"{R} lanes x {T} tags, {hashes} hashes")
    spec = MUTATE_TIMED[label]
    if spec[0] == "flat":
        _, n, d = spec
        key = rng.fold_in(rng.root_key(0), 1)
        ref = rng.flat_uniforms_plain(key, n, d, dev)
        per = rng.flat_per_thread(n * d, sms)
        kernel = f"mlt_flat_uniforms_kernelILi{per}E"
        return dict(label=label, kind="flat", lanes=n, run=lambda mod: (mod.flat_uniforms(
                        key, n, d, dev),), equal=lambda o: same(o, (ref,)),
                    plain=lambda: rng.flat_uniforms_plain(key, n, d, dev),
                    bound=timing.bound_ms(4 * n * d, f32_ops=n * d,
                                          i32_ops=n * d * OPS_PER_UNIFORM),
                    kernel=kernel, threads=rng.MUTATE_THREADS, smem=0,
                    issue=lambda lib_path, mhz, sms_: warp_ms(
                        n * d * per_hash(sass_hash_loops(lib_path, kernel)["total"]), mhz, sms_),
                    work=f"{n * d} hashes, {per} a thread")
    N, D, p_large = spec
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    u = torch.rand((N, D), generator=gen, device=dev)
    keys = rng.mutate_keys(rng.fold_in(rng.root_key(0), 1005))
    ref = rng.mutate_plain(u, keys, p_large)
    n_large = int(ref[1].sum())
    n_small = N - n_large
    hashes = n_large * D + 2 * n_small * D + 2 * N

    def issue(lib_path, mhz, sms_):
        sass = sass_hash_loops(lib_path, "mlt_mutate_kernel")
        loop = next(lp for lp in sass["loops"] if lp["EX2"])  # the element loop
        return warp_ms((hashes - 2 * N) * per_hash(loop) + 2 * N * per_hash(sass["rest"]),
                       mhz, sms_)

    return dict(label=label, kind="mutate", lanes=N, run=lambda mod: mod.mutate(u, keys, p_large),
                equal=lambda o: same(o, ref), plain=lambda: rng.mutate_plain(u, keys, p_large),
                bound=timing.bound_ms(
                    8 * N * D + 5 * N,
                    f32_ops=n_small * D * OPS_MUTATE_SMALL_F32 + N * OPS_MUTATE_CHAIN_F32,
                    i32_ops=hashes * OPS_PER_UNIFORM),
                kernel="mlt_mutate_kernel", threads=rng.MUTATE_THREADS, smem=rng.MUTATE_MAX_BAND,
                issue=issue, work=f"{n_large} large chains, {hashes} hashes")


def rng_case_timed(case: dict, lib, rounds: int = RNG_ROUNDS) -> dict:
    """A ``rng_timed_case`` held to its plain version, then timed through
    this tree's wrappers (``timing.queued_rounds``, ``nvidia-smi``'s SM
    clock sampled meanwhile) beside its bound, issue-slot bound, the
    kernel's registers (ptxas) and blocks per SM; logs a line. → dict."""
    import torch

    from pbrt_torch.core import rng
    from pbrt_torch.utils import native, timing

    if not case["equal"](case["run"](rng)):
        raise SystemExit(f"{case['kind']} ({case['label']}) disagrees with its plain version")
    regs = next((v for f, v in kernel_registers(lib._name, native.build_log.get("pbrt_torch_rng"))
                 .items() if case["kernel"] in f), None)
    blocks = blocks_per_sm(regs, case["smem"], case["threads"]) if regs else None
    with SmClock() as clk:
        tq = timing.queued_rounds(lambda: case["run"](rng), rounds)
        t_end = time.time() + 0.5  # a short case: launches go on until the clock is read
        while time.time() < t_end:
            case["run"](rng)
        torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = case["issue"](lib._name, clk.mhz, sms) if clk.mhz else None
    b_ms, b_by = case["bound"]
    name = "keyed_camera_normals" if case["kind"] == "normals" else "mlt_mutate"
    log("timing", f"{name} ({case['label']}; {case['work']}): bit-equal to the plain version; "
        f"median {tq['ms']:.5f} ms over {rounds} rounds ({tq['min']:.5f}–{tq['max']:.5f}; host "
        f"enqueue {tq['host_ms']:.4f} ms); bound {b_ms:.5f} ms ({b_by}), kernel / bound "
        f"{tq['ms'] / b_ms:.2f}x; issue-slot bound "
        + (f"{issue:.5f} ms (at {clk.mhz:g} MHz), kernel / issue bound {tq['ms'] / issue:.2f}x"
           if issue else "not measured (no SM clock read)")
        + f"; {case['kernel']}: {regs} registers, {blocks} blocks of {case['threads']} threads "
        f"per SM")
    return dict(tq, bound_ms=b_ms, bound_by=b_by, issue_bound_ms=issue, sm_mhz=clk.mhz,
                registers=regs, blocks_per_sm=blocks)


class SmClock:
    """``nvidia-smi``'s ``clocks.sm`` of card 0 sampled every 50 ms while
    the block runs (``mhz``: the samples' median, None where none came)."""

    def __enter__(self):
        import subprocess

        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
             "-lms", "50"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        import statistics

        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        vals = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
        self.mhz = statistics.median(vals) if vals else None
        return False


def issue_bound_ms(n_active: int, n_points: int, per_lane_point: float, mhz: float,
                   sms: int = 132) -> float:
    """The least time the SMs' 4 schedulers each could issue ``per_lane_point``
    warp instructions for every (active lane, point), at ``mhz``."""
    return n_active * n_points * per_lane_point / (sms * 4 * mhz * 1e6) * 1e3


def reflected_and_transmitted(built, dev, n_cam: int, gen):
    """The scene's first specular bounces: from the hits of ``n_cam``
    camera rays, each hit's mirror direction about the shading normal and
    its refraction at the hit material's index (total internal reflection
    dropped), origins offset as the integrator offsets them; → (o, d) of
    ``n_cam`` lanes, half reflected, half transmitted, and the counts."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.bsdf import bxdf
    from pbrt_torch.core.interaction import offset_ray_origin, surface_interaction

    W, H = built.film_config.xres, built.film_config.yres
    g = built.scene.geometry
    pix = torch.arange(n_cam, device=dev) % (W * H)
    px = (pix % W).float() + torch.rand(n_cam, generator=gen, device=dev)
    py = (pix // W).float() + torch.rand(n_cam, generator=gen, device=dev)
    z = torch.zeros(n_cam, device=dev)
    cam = built.camera.generate_rays(px, py, z, z, z)
    si = surface_interaction(g, cam, isect.intersect(g, cam))
    h = torch.nonzero(si.valid).squeeze(1)
    ns, ng, p, eps = si.ns[h], si.ng[h], si.p[h], si.ray_epsilon[h]
    ss, ts = bxdf.make_shading_frame(ns, si.dpdu[h])
    wo = bxdf.world_to_local(si.wo[h], ss, ts, ns)
    eta = built.scene.materials.eta[si.material[h].clamp(min=0)]
    refl = bxdf.local_to_world(bxdf.specular_reflect_dir(wo), ss, ts, ns)
    trans, ok, _ = bxdf.specular_transmit_dir(wo, 1.0, eta)
    trans = bxdf.local_to_world(trans, ss, ts, ns)
    half = n_cam // 2
    pick_r = torch.randperm(h.numel(), generator=gen, device=dev)[:half]
    t_ok = torch.nonzero(ok).squeeze(1)
    pick_t = t_ok[torch.randperm(t_ok.numel(), generator=gen, device=dev)[:half]]
    o = torch.cat([offset_ray_origin(p[pick_r], ng[pick_r], refl[pick_r], eps[pick_r]),
                   offset_ray_origin(p[pick_t], ng[pick_t], trans[pick_t], eps[pick_t])])
    d = torch.cat([refl[pick_r], trans[pick_t]])
    return o.contiguous(), d.contiguous(), int(h.numel()), int(t_ok.numel())


def materials_phase(dev, data_dir, drive, profile_frame, card_vs_cpu):
    """Phase 9: the materials-and-environment scene at 512² (its files
    generated into ``data_dir``): the traversal kernels against their plain
    versions on its first reflected and transmitted rays, ``path`` and
    ``directlighting`` renders with their profiles, then its 16² version
    on the card and on the CPU."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build

    write_material_data(data_dir)
    text, _ = real_scene_text()
    t0 = time.time()
    built = build(load_scene_string(materials_scene_text(text, data_dir, "path")), device=dev)
    mt, lt, g = built.scene.materials, built.scene.lights, built.scene.geometry
    log("scene", f"materials-and-environment scene: {g.num_triangles} triangles, "
        f"{g.num_quadrics} spheres, material kinds {sorted(set(mt.kind.tolist()))}, "
        f"lobe codes {list(mt.active_lobes)}, light types {lt.type.tolist()} (area lights "
        f"from row {lt.area_row0}), env map {tuple(lt.env_map.shape)}, light maps "
        f"{tuple(lt.lmap.shape)}, measured pools: {mt.irreg_points.shape[0]} .brdf rows, "
        f"{mt.merl_rgb.shape[0]} MERL rows; built in {time.time() - t0:.1f} s")
    if set(mt.kind.tolist()) != set(range(14)) - {3, 11, 12} or lt.type.tolist() != [4, 5, 6, 3]:
        raise SystemExit("the materials-and-environment scene lacks a material or light kind")

    # the traversal kernels on the first reflected and transmitted rays
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    o, d, n_hits, n_trans = reflected_and_transmitted(built, dev, N_LANES, gen)
    R = o.shape[0]
    inv = isect.make_inv_dir(d).contiguous()
    tmin = torch.zeros(R, device=dev)
    tmax = torch.full((R,), float("inf"), device=dev)
    rows, ws = g.wide_rows, g.wide_stack
    equal = {}
    q = [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmax)]
    kc = tc.traverse(rows, ws, o, d, inv, tmin, tmax, *q, any_hit=False)
    pc = tc.traverse_plain(rows, ws, o, d, inv, tmin, tmax, *q, any_hit=False)
    equal["closest"] = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                           for a, b in zip(kc, pc))
    scale = torch.where(torch.rand(R, generator=gen, device=dev) < 0.5, 0.5, 1.5)
    tmax_a = torch.where(torch.isfinite(pc[0]), pc[0] * scale, 1e30).contiguous()
    qa = [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmax_a)]
    ka = tc.traverse(rows, ws, o, d, inv, tmin, tmax_a, *qa, any_hit=True)
    pa = tc.traverse_plain(rows, ws, o, d, inv, tmin, tmax_a, *qa, any_hit=True)
    equal["any"] = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(ka, pa))
    torch.cuda.synchronize()
    log("kernels", f"materials scene, {R} lanes ({R // 2} reflected, {R - R // 2} transmitted "
        f"rays, from {n_hits} camera hits, {n_trans} without total internal reflection): "
        f"closest-hit and any-hit kernels vs plain equal bit for bit {equal}; closest hits "
        f"{int((pc[1] >= 0).sum())} ({int(torch.isinf(pc[0]).sum())} escape), occluded "
        f"{int((pa[1] >= 0).sum())}")
    if not all(equal.values()) or R < N_LANES:
        raise SystemExit("a traversal kernel disagrees with its plain version on the "
                         "materials scene's reflected and transmitted rays")
    del kc, pc, ka, pa, q, qa

    for kind in ("path", "directlighting"):
        b = dataclasses.replace(built, integrator=dataclasses.replace(
            built.integrator, kind=kind, max_depth=SCENE_DEPTH))
        label = f"materials and environment with {kind}, depth {SCENE_DEPTH}"
        _, sec, _, _ = drive(label, b, 1)
        profile_frame(f"{label}, chunk 0", b, sec * 1e3, run=chunk_wave(b, dev),
                      scale=chunks_of(b))
    del built, b
    torch.cuda.empty_cache()

    small_text, _ = real_scene_text(SMALL_BLOB_FREQ, res=16)
    for kind in ("path", "directlighting"):
        card_vs_cpu(f"materials-and-environment scene ({20 * SMALL_BLOB_FREQ ** 2}-triangle "
                    "blobs)", materials_scene_text(small_text, data_dir, kind),
                    spp=1, chunk_pixels=256)


#: goldens/metal.pbrt's three texture bindings and their declarations, and
#: what the untextured frame puts in their place (Kd .5, no bump map)
METAL_TEXTURE_LINES = (
    ('Texture "tmap" "color" "imagemap" "string filename" "textures/lines.exr"\n'
     '\t"float uscale" 60 "float vscale" 60\n', ''),
    ('Texture "tbump-tex" "float" "imagemap" "string filename" "textures/lines.exr"\n'
     '\t"float uscale" 60 "float vscale" 60\n', ''),
    ('Texture "sbump" "float" "scale" "texture tex1" "tbump-tex"\n\t"float  tex2" [-.25]\n', ''),
    ('"texture Kd" "tmap"', '"color Kd" [.5 .5 .5]'),
    ('"texture bumpmap" "sbump"', ''),
)


def load_checked(path, dev, what):
    """Builds the scene file ``path`` on ``dev`` and fails on any warning
    (an image texture that did not load would render black with one)."""
    import warnings

    from pbrt_torch.scene.api import load_scene
    from pbrt_torch.scene.builder import build

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        built = build(load_scene(path), device=dev)
    if caught:
        raise SystemExit(f"{what}: warnings while building: "
                         + "; ".join(str(w.message) for w in caught))
    return built


def textures_phase(dev, data_dir, drive, profile_frame, card_vs_cpu):
    """Phase 10: ``goldens/metal.pbrt`` as written (its files generated
    into ``data_dir``) at its 256², 16 spp, then at 1 spp without its
    textures; the texture-kinds scene at 512²; both at 16² on the card and
    on the CPU."""
    t0 = time.time()
    write_texture_data(data_dir)
    with open(os.path.join(HERE, "goldens", "metal.pbrt")) as f:
        metal = f.read()
    metal_path = os.path.join(data_dir, "metal.pbrt")
    with open(metal_path, "w") as f:
        f.write(metal)
    built = load_checked(metal_path, dev, "goldens/metal.pbrt")
    sc, fc, ic = built.scene, built.film_config, built.integrator
    tt, g, lt = sc.textures, sc.geometry, sc.lights
    images = [r for r, k in enumerate(tt.kinds) if k == 4]
    log("scene", f"goldens/metal.pbrt as written: {g.num_triangles} triangles, texture kinds "
        f"{list(tt.kinds)}, texture rows bound {sc.materials.tex_rows}, image rows {images} "
        f"with {tt.img_n_levels[images].tolist()} mip levels from "
        f"{tt.img_w[images].tolist()}x{tt.img_h[images].tolist()}, pool {tt.pool_rgb.shape[0]} "
        f"texels, env map {tuple(lt.env_map.shape)}, pixel spread {sc.pixel_spread:.6g}, "
        f"{ic.kind} depth {ic.max_depth}, {fc.xres}x{fc.yres}, {built.pixel_samples} spp; files "
        f"generated and scene built in {time.time() - t0:.1f} s")
    if not (sc.has_textures and sc.materials.has_bump and len(images) == 2
            and tt.pool_rgb.shape[0] > 1 and (tt.img_offset[images] > 0).all()
            and tuple(lt.env_map.shape[:2]) == (512, 1024) and ic.kind == "path"
            and (fc.xres, fc.yres, built.pixel_samples) == (256, 256, 16)
            and g.num_triangles == 2 + 20 * 57 ** 2):
        raise SystemExit("goldens/metal.pbrt did not build as written with its generated files")
    spp = built.pixel_samples
    _, sec, _, _ = drive("goldens/metal.pbrt as written", built, spp)
    textured = profile_frame("goldens/metal.pbrt as written (path)", built, sec / spp * 1e3)
    plain = metal
    for old, new in METAL_TEXTURE_LINES:
        if old not in plain:
            raise ValueError(f"goldens/metal.pbrt has no {old!r}")
        plain = plain.replace(old, new, 1)
    plain_path = os.path.join(data_dir, "metal-untextured.pbrt")
    with open(plain_path, "w") as f:
        f.write(plain)
    bu = load_checked(plain_path, dev, "metal.pbrt without textures")
    if bu.scene.has_textures:
        raise SystemExit("the untextured metal.pbrt still has textures")
    _, sec_u, _, _ = drive("goldens/metal.pbrt without its textures", bu, 1)
    untextured = profile_frame("goldens/metal.pbrt without its textures", bu, sec_u * 1e3)
    log("textures", f"goldens/metal.pbrt, 1-spp frame: textured {textured['per_chunk']:.1f} "
        f"launches per chunk and {textured['ms']:.1f} ms of kernel time, against "
        f"{untextured['per_chunk']:.1f} and {untextured['ms']:.1f} ms with Kd .5 and no bump map "
        f"({textured['per_chunk'] / untextured['per_chunk']:.2f}x the launches, "
        f"{textured['ms'] / untextured['ms']:.2f}x the kernel time)")
    del built, bu

    text, _ = real_scene_text()
    kinds_path = os.path.join(data_dir, "kinds.pbrt")
    with open(kinds_path, "w") as f:
        f.write(texture_kinds_text(text, data_dir))
    kinds = load_checked(kinds_path, dev, "texture-kinds scene")
    tt = kinds.scene.textures
    log("scene", f"texture-kinds scene: {kinds.scene.geometry.num_triangles} triangles, "
        f"{kinds.scene.geometry.num_quadrics} spheres, texture kinds {sorted(set(tt.kinds))}, "
        f"mappings {sorted(set(tt.mappings))}, rows bound {kinds.scene.materials.tex_rows}")
    if set(tt.kinds) != set(range(1, 13)) or set(tt.mappings) != {0, 1, 3}:
        raise SystemExit("the texture-kinds scene lacks a texture kind or mapping")
    kinds = dataclasses.replace(kinds, integrator=dataclasses.replace(
        kinds.integrator, max_depth=SCENE_DEPTH))
    label = f"texture-kinds scene with path, depth {SCENE_DEPTH}"
    _, sec_k, _, _ = drive(label, kinds, 1)
    profile_frame(f"{label}, chunk 0", kinds, sec_k * 1e3, run=chunk_wave(kinds, dev),
                  scale=chunks_of(kinds))
    del kinds
    import torch

    torch.cuda.empty_cache()

    small = os.path.join(data_dir, "small")
    write_texture_data(small, teapot_freq=SMALL_BLOB_FREQ)
    small_metal = os.path.join(small, "metal16.pbrt")
    with open(small_metal, "w") as f:
        f.write(metal.replace('"integer xresolution" [256] "integer yresolution" [256]',
                              '"integer xresolution" [16] "integer yresolution" [16]'))
    card_vs_cpu(f"goldens/metal.pbrt ({20 * SMALL_BLOB_FREQ ** 2}-triangle teapot)", None,
                spp=2, chunk_pixels=256, scene_path=small_metal, waves=TEXTURE_REF_WAVES)
    small_text, _ = real_scene_text(SMALL_BLOB_FREQ, res=16)
    kinds_path = os.path.join(small, "kinds16.pbrt")
    with open(kinds_path, "w") as f:
        f.write(texture_kinds_text(small_text, small))
    card_vs_cpu(f"texture-kinds scene ({20 * SMALL_BLOB_FREQ ** 2}-triangle blobs)", None,
                spp=1, chunk_pixels=256, scene_path=kinds_path, waves=TEXTURE_REF_WAVES)


#: the D-Gauss F/2 of US patent 2,673,491 scaled to 50 mm (the form
#: pbrt-v3 ships as dgauss.50mm.dat): ten surfaces and the stop, front to
#: back, as (radius, separation, n, aperture) rows after the focal length
DGAUSS_50MM = """# focal length
50
# radius separation n aperture
29.475 3.76 1.67 25.2
84.83 0.12 1 25.2
19.275 4.025 1.67 23
40.77 3.275 1.699 23
12.75 5.705 1 18
0 4.5 0 17.1
-14.495 1.18 1.603 17
40.77 6.065 1.658 20
-20.385 0.19 1 20
437.065 3.22 1.717 20
-39.73 5 1 20
"""
#: a generated 4-surface schematic eye in the Zemax sign convention (read
#: with flipLensRadius): cornea front and back, the pupil, the lens front
#: and back, as [radiusX radiusY thickness medium semi-diameter conicX
#: conicY] rows after the effective focal length, front to back
SCHEMATIC_EYE = """16.7
-7.72 -7.72 0.55 1 5.0 0.26 0.26
-6.50 -6.50 3.05 2 5.0 0 0
0 0 0.0 0 2.0 0 0
-10.2 -10.2 4.0 3 4.5 3.13 3.13
6.0 6.0 0 4 4.5 1.0 1.0
"""
#: the eye's media (cornea, aqueous, lens, vitreous) as (λ nm, n) pairs
EYE_MEDIA = {"ior1": (400, 1.3854, 550, 1.3771, 700, 1.3725),
             "ior2": (400, 1.3436, 550, 1.3374, 700, 1.3339),
             "ior3": (400, 1.4299, 550, 1.4200, 700, 1.4149),
             "ior4": (400, 1.3424, 550, 1.3360, 700, 1.3325)}
#: the lens cameras of phase 12 on the killeroo-simple scene (@DIR@: the
#: directory of the generated files); the lens traces in millimetres of
#: camera space, so the stack's front sits ~37 units ahead of the camera
#: and the film distance sets how many lanes live (PERF.md §4)
LENS_CAMERAS = {
    "realisticDiffraction": (
        'Camera "realisticDiffraction" "string specfile" ["@DIR@/dgauss.50mm.dat"] '
        '"float filmdistance" [57] "float aperture_diameter" [17.1] "float filmdiag" [35] '
        '"bool diffractionEnabled" ["true"] "bool chromaticAberrationEnabled" ["true"]'),
    "realisticEye": (
        'Camera "realisticEye" "string specfile" ["@DIR@/eye.dat"] "bool flipLensRadius" '
        '["true"] "float retinaDistance" [16.32] "float retinaRadius" [12] '
        '"float retinaSemiDiam" [6] "float pupilDiameter" [4] "float filmdiag" [12] '
        + " ".join(f'"spectrum {k}" [{" ".join(map(str, v))}]' for k, v in EYE_MEDIA.items())),
    "idealDiffraction": (
        'Camera "idealDiffraction" "float focal_length" [50] "float filmdistance" [57] '
        '"float aperture_diameter" [4] "float filmdiag" [35]'),
    "orthographic": 'Camera "orthographic" "float screenwindow" [-160 160 -160 160]',
    "pinhole": 'Camera "pinhole" "float filmdistance" [2.9]',
    "environment": 'Camera "environment"',
}


def write_lens_data(directory: str):
    """The lens and eye prescriptions of ``LENS_CAMERAS`` as files of floats
    in ``directory``."""
    for name, text in (("dgauss.50mm.dat", DGAUSS_50MM), ("eye.dat", SCHEMATIC_EYE)):
        with open(os.path.join(directory, name), "w") as f:
            f.write(text)


def lens_scene_text(text: str, camera: str, directory: str, renderer: str = "") -> str:
    """The killeroo-simple scene ``text`` seen through ``LENS_CAMERAS[camera]``
    (or the directive ``camera``), with a ``Renderer`` directive."""
    line = LENS_CAMERAS.get(camera, camera).replace("@DIR@", directory)
    return text.replace('Camera "perspective" "float fov" [39]', f"{line}\n{renderer}")


def camera_and_bounce_rays(built, dev, n_lanes: int, gen, times: bool):
    """``n_lanes`` rays of a built scene: camera rays through jittered
    pixels (each at its own uniform shutter time if ``times``), then
    cosine-distributed bounce rays from their first hits, at their camera
    ray's time; → (o, d, time, the camera rays, their interactions)."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.bsdf import bxdf
    from pbrt_torch.core import sampling as smp
    from pbrt_torch.core.interaction import offset_ray_origin, surface_interaction

    W, H = built.film_config.xres, built.film_config.yres
    g = built.scene.geometry
    n_cam = n_lanes // 2
    pix = torch.arange(n_cam, device=dev) % (W * H)
    px = (pix % W).float() + torch.rand(n_cam, generator=gen, device=dev)
    py = (pix // W).float() + torch.rand(n_cam, generator=gen, device=dev)
    z = torch.zeros(n_cam, device=dev)
    u_time = torch.rand(n_cam, generator=gen, device=dev) if times else z
    cam = built.camera.generate_rays(px, py, z, z, u_time)
    si = surface_interaction(g, cam, isect.intersect(g, cam))
    hits = torch.nonzero(si.valid).squeeze(1)
    src = hits[torch.arange(n_lanes - n_cam, device=dev) % hits.numel()]
    ss, ts = bxdf.make_shading_frame(si.ns[src], si.dpdu[src])
    u1 = torch.rand(src.numel(), generator=gen, device=dev)
    u2 = torch.rand(src.numel(), generator=gen, device=dev)
    w = bxdf.local_to_world(smp.cosine_sample_hemisphere(u1, u2), ss, ts, si.ns[src])
    ob = offset_ray_origin(si.p[src], si.ng[src], w, si.ray_epsilon[src])
    return (torch.cat([cam.origin, ob]).contiguous(), torch.cat([cam.direction, w]).contiguous(),
            torch.cat([cam.time, cam.time[src]]).contiguous(), cam, si)


def motion_lane_sets(built, dev) -> dict:
    """Phase 11(c)'s rays of the motion scene (seed 11): ``N_LANES`` camera
    and bounce rays at their own shutter times (o, d, t_ray and the camera
    rays' interactions si), then, drawn in this order, each lane's any-hit
    scale (0.5 or 1.5 times its closest hit), the ``BRUTE_LANES`` lanes
    held to ``intersect_brute`` and the permuted ``CHUNK``-lane timing set
    (sel, sub); gen, the generator after them."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    o, d, t_ray, _, si = camera_and_bounce_rays(built, dev, N_LANES, gen, times=True)
    R = o.shape[0]
    scale = torch.where(torch.rand(R, generator=gen, device=dev) < 0.5, 0.5, 1.5)
    sel = torch.randperm(R, generator=gen, device=dev)[:BRUTE_LANES]
    sub = torch.randperm(R, generator=gen, device=dev)[:CHUNK]
    return dict(o=o, d=d, t_ray=t_ray, si=si, scale=scale, sel=sel, sub=sub, gen=gen)


def walk_seeds(g, o, d, tmin, tmax):
    """The quadric pass that seeds a walk, as ``intersect`` seeds it: (t,
    prim, b1, b2), each contiguous, or no hit (tmax, -1, 0, 0) in a scene
    without quadrics."""
    import torch

    from pbrt_torch.accel import intersect as isect

    if g.num_quadrics:
        return [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmax)]
    R, dev = o.shape[0], o.device
    return [tmax.clone(), torch.full((R,), -1, dtype=torch.int32, device=dev),
            torch.zeros(R, device=dev), torch.zeros(R, device=dev)]


def instance_lane_sets(built, dev) -> dict:
    """Phase 11(b)'s rays of the instanced scene (seed 12): ``N_LANES``
    camera and bounce rays (o, d and the camera rays' interactions si),
    then, drawn in this order, each lane's any-hit scale (0.5 or 1.5 times
    its closest hit) and the permuted ``CHUNK``-lane timing set (sub)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    o, d, _, _, si = camera_and_bounce_rays(built, dev, N_LANES, gen, times=False)
    R = o.shape[0]
    scale = torch.where(torch.rand(R, generator=gen, device=dev) < 0.5, 0.5, 1.5)
    sub = torch.randperm(R, generator=gen, device=dev)[:CHUNK]
    return dict(o=o, d=d, si=si, scale=scale, sub=sub)


def instance_timed_args(g, sets) -> dict:
    """The instance kernels' timed inputs on phase 11(b)'s permuted set
    (``instance_lane_sets``): {kernel key: (o, d, inv, tmin, tmax, t, prim,
    b1, b2)}, each contiguous. Closest hit on unbounded rays seeded with
    the world walk; any hit on segments cut at the lane's scale times its
    closest hit (1e30 without one; the closest hit from
    ``traverse_instances``, as phase 11(b) cuts them), seeded with the
    world any-hit walk."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_cuda as tc

    pick = lambda x: x[sets["sub"]].contiguous()
    o, d = pick(sets["o"]), pick(sets["d"])
    R, dev = o.shape[0], o.device
    inv = isect.make_inv_dir(d).contiguous()
    tmin = torch.zeros(R, device=dev)
    itab = (g.inst_rows, g.inst_stack, g.inst_w2o, g.inst_lo, g.inst_hi, g.inst_root)
    out = {}
    tmax = torch.full((R,), float("inf"), device=dev)
    for key, any_hit in (("traverse_instances_closest", False), ("traverse_instances_any", True)):
        if any_hit:
            t_c = tc.traverse_instances(*itab, *out["traverse_instances_closest"],
                                        any_hit=False)[0]
            tmax = torch.where(torch.isfinite(t_c), t_c * pick(sets["scale"]), 1e30).contiguous()
        world = tc.traverse(g.wide_rows, g.wide_stack, o, d, inv, tmin, tmax,
                            *walk_seeds(g, o, d, tmin, tmax), any_hit=any_hit)
        out[key] = (o, d, inv, tmin, tmax, *world)
    return out


def instance_schedule_summary(stats: dict) -> str:
    """The instance phase's per-lane and per-warp counts
    (``traverse_instances_plain``'s stats) as a log fragment."""
    f = lambda x: f"{float(x.double().mean()):.3f} (max {int(x.max())})"
    return (f"per lane: walks {f(stats['walks_lane'])}, BLAS steps {f(stats['lane_steps'])}, "
            f"box tests {float(stats['box_tests_lane'].double().mean()):.2f}; per warp of 4 "
            f"lanes, steps walking one instance at a time for the warp "
            f"{f(stats['warp_serial_steps'])} against each lane through its own candidates "
            f"{f(stats['warp_own_steps'])}")


def kernel_registers(lib_path: str, log: str | None = None) -> dict:
    """{kernel function (mangled): registers} of a kernel library: from
    ptxas' verbose report (``-Xptxas -v``) of its build where given, else
    from ``cuobjdump -res-usage`` of the library (the same count)."""
    import re
    import subprocess

    from pbrt_torch.utils import native

    if log is None:
        tool = os.path.join(os.path.dirname(native.nvcc_path()), "cuobjdump")
        log = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                             check=True).stdout
    regs, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for |Function )"
                      r"([A-Za-z_][\w.$]*)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"(?:Used (\d+) registers|REG:(\d+))", ln)
        if m and fn:
            regs[fn] = int(m.group(1) or m.group(2))
    return regs


def blocks_per_sm(registers: int, smem_bytes: int, threads: int = 128) -> int:
    """Resident blocks per SM on an H100 by CUDA's occupancy rules: 65,536
    registers an SM in units of 256 a warp, 228 KiB of shared memory with 1
    KiB reserved a block, 64 warps and 32 blocks."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps
    by_smem = 228 * 1024 // (smem_bytes + 1024)
    return min(by_regs, by_smem, 64 // warps, 32)


def motion_work(stats: dict, lanes: int):
    """(bytes, float operations) a motion walk must move and do, from the
    culled plain walk's ``stats`` on ``lanes`` lanes: each lane's ray,
    shutter weight and result once; each distinct node row's fields with
    their deltas and time boxes, each leaf row's with their deltas; per
    node step the slab tests, sort, lerps and time-box tests, per leaf step
    the lerped Möller–Trumbore tests."""
    nbytes = (lanes * LANE_BYTES_MOTION
              + stats["node_rows"] * (NODE_ROW_BYTES + NODE_DELTA_BYTES + TBOX_BYTES
                                      + TBOX_DELTA_BYTES)
              + stats["leaf_rows"] * (LEAF_ROW_BYTES + LEAF_DELTA_BYTES))
    ops = (stats["node_steps"] * (OPS_NODE_STEP + OPS_NODE_LERP + OPS_TBOX_LERP + OPS_TBOX_TEST)
           + stats["leaf_steps"] * (OPS_LEAF_STEP + OPS_LEAF_LERP))
    return nbytes, ops


def geometry_bytes(g) -> int:
    """Device bytes of a SceneGeometry's tensors."""
    import torch

    return sum(v.numel() * v.element_size() for v in vars(g).values() if torch.is_tensor(v))


def motion_instancing_phase(dev, drive, profile_frame, card_vs_cpu):
    """Phase 11: ``goldens/anim-killeroos-moving.pbrt`` as written (and
    with its shutter pinned), 64 instanced killeroos at 512², the motion
    and instance kernels against their plain versions and timed, and the
    16² references. → the four kernels' entries of the kernels line."""
    import torch

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.core import geometry as geom
    from pbrt_torch.renderers.sampler import render
    from pbrt_torch.scene.api import load_scene_string
    from pbrt_torch.scene.builder import build
    from pbrt_torch.utils import native, timing
    from pbrt_torch.utils.timing import cuda_ms, queued_ms

    sync = torch.cuda.synchronize
    bits = lambda k, p: all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                            for a, b in zip(k, p))
    entries = {}

    # ---- (a) goldens/anim-killeroos-moving.pbrt as written --------------
    t0 = time.time()
    text = anim_scene_text()
    built = build(load_scene_string(text), device=dev)
    g, ic, fc = built.scene.geometry, built.integrator, built.film_config
    moving = int((g.tri_motion.abs().sum(1) > 0).sum())
    log("scene", f"goldens/anim-killeroos-moving.pbrt as written: {g.num_triangles} triangles "
        f"({moving} moving), {g.num_quadrics} sphere, motion interval {g.motion_span}, "
        f"{g.wide_rows.shape[0]} wide rows with their deltas, wide_stack {g.wide_stack}, "
        f"{ic.kind} depth {ic.max_depth}, {fc.xres}x{fc.yres}, {built.pixel_samples} spp; "
        f"built in {time.time() - t0:.1f} s")
    if not (g.has_motion and moving == 2 * 20 * 57 ** 2 and g.num_triangles == moving + 4
            and ic.kind == "directlighting" and (fc.xres, fc.yres) == (256, 256)
            and built.pixel_samples == 8):
        raise SystemExit("goldens/anim-killeroos-moving.pbrt did not build as written")
    spp = built.pixel_samples
    film, sec, launches, _ = drive("anim-killeroos-moving as written", built, spp)
    if (launches["traverse_closest_motion"] == 0 or launches["traverse_any_motion"] == 0
            or launches["traverse_closest"] or launches["traverse_any"]):
        raise SystemExit("the motion scene did not launch the motion kernels alone")
    motion_launches = launches
    profile_frame("anim-killeroos-moving as written (directlighting)", built, sec / spp * 1e3)
    pinned = text.replace('Camera "perspective" "float fov" [39]',
                          'Camera "perspective" "float fov" [39] "float shutteropen" [0] '
                          '"float shutterclose" [0]')
    fp = render(build(load_scene_string(pinned), device=dev), spp=spp, seed=0, chunk_pixels=CHUNK)
    sync()
    rel = float((film.pixels - fp.pixels).abs().sum() / fp.pixels.abs().sum())
    a, b = film.pixels.sum(-1), fp.pixels.sum(-1)
    px_diff = float(((a - b).abs() > 0.05 * torch.maximum(a, b).clamp(min=1e-12)).float().mean())
    log("motion", f"anim-killeroos-moving, {spp} spp, seed 0: film against the shutter pinned "
        f"at 0 (shutteropen = shutterclose = 0): L1 difference {rel:.4f} of the pinned film's, "
        f"{100 * px_diff:.2f}% of pixels differ by more than 5%; film sums "
        f"{float(film.pixels.double().sum()):.6g} and {float(fp.pixels.double().sum()):.6g}")
    if px_diff < 0.02:
        raise SystemExit("the motion scene's frame equals the pinned one: no smear")
    del fp

    # ---- (c) the motion kernels on 1,048,576 of its rays ----------------
    # The kernels walk all of them; the plain walks run on the timed set
    # (32,768 of them) only: a plain walk loops until its longest ray ends
    # (4,717 steps here), so on all the rays it took as long again (52–71
    # s) for the same check
    sets = motion_lane_sets(built, dev)
    o, d, t_ray, si, gen = (sets[k] for k in ("o", "d", "t_ray", "si", "gen"))
    n_hits = int(si.valid.sum())
    R = o.shape[0]
    tw = isect.motion_weight(g, t_ray).contiguous()
    inv = isect.make_inv_dir(d).contiguous()
    tmin = torch.zeros(R, device=dev)
    tmax = torch.full((R,), float("inf"), device=dev)
    q = [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmax)]
    rows, mrows, ws, tbox = g.wide_rows, g.wide_motion, g.wide_stack, g.wide_tbox
    mo = dict(motion_rows=mrows, tw=tw, time_boxes=tbox)
    kc = tc.traverse(rows, ws, o, d, inv, tmin, tmax, *q, any_hit=False, **mo)
    tmax_a = torch.where(torch.isfinite(kc[0]), kc[0] * sets["scale"], 1e30).contiguous()
    qa = [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmax_a)]
    ka = tc.traverse(rows, ws, o, d, inv, tmin, tmax_a, *qa, any_hit=True, **mo)
    # the ragged counts held to the union walk (the kernels cull by the
    # time boxes, the union walk is the JAX package's)
    ragged = True
    for n in (1, 7, 4093):
        cut = lambda xs: [x[:n].contiguous() for x in xs]
        for any_hit, tm, seeds in ((False, tmax, q), (True, tmax_a, qa)):
            a = cut((o, d, inv, tmin, tm, *seeds))
            mt = dict(motion_rows=mrows, tw=tw[:n].contiguous())
            ragged &= bits(tc.traverse(rows, ws, *a, any_hit=any_hit, time_boxes=tbox, **mt),
                           tc.traverse_plain(rows, ws, *a, any_hit, **mt))
    sel = sets["sel"]
    hb = isect.intersect_brute(g, geom.Ray.make(o[sel], d[sel], time=t_ray[sel]))
    sync()
    kv, bv = kc[1][sel] >= 0, hb.prim >= 0
    v = kv & bv
    brute_rel = float(((kc[0][sel][v] - hb.t[v]).abs() / hb.t[v].abs()).max()) if v.any() else 0.0
    sub = sets["sub"]
    pick = lambda x: x[sub].contiguous()
    so, sd, sinv, stmin = pick(o), pick(d), pick(inv), pick(tmin)
    eq, errs = {}, {}
    for key, any_hit, tm, seeds, kern in (("traverse_closest_motion", False, tmax, q, kc),
                                          ("traverse_any_motion", True, tmax_a, qa, ka)):
        targs = (rows, ws, so, sd, sinv, stmin, pick(tm), *[pick(x) for x in seeds])
        mt = dict(motion_rows=mrows, tw=pick(tw))
        mc = dict(mt, time_boxes=tbox)
        # the union walk (the JAX package's), counting its steps: the
        # reference the kernels' lanes of the set are held to (the walk of
        # its longest ray sets its time: tens of seconds here); then the
        # culled walk, the kernel's own plain version, timed, whose work
        # gives the bound
        stats_u, union = {}, []
        union_ms = cuda_ms(lambda: union.append(tc.traverse_plain(*targs, any_hit, stats=stats_u,
                                                                  **mt)), n=1, warm=0)
        stats, plain = {}, []
        plain_ms = cuda_ms(lambda: plain.append(tc.traverse_plain(*targs, any_hit, stats=stats,
                                                                  **mc)), n=1, warm=0)
        ks, ps, pu = [pick(x) for x in kern], plain[0], union[0]
        eq[key] = (bits(ks, pu) and bits(ps, pu)
                   and bits(tc.traverse(*targs, any_hit=any_hit, **mc), pu))
        hit = torch.isfinite(pu[0]) if not any_hit else pu[1] >= 0
        errs[key] = float((ks[0][hit] - pu[0][hit]).abs().max()) if hit.any() else 0.0
        ms, host_ms = queued_ms(lambda: tc.traverse(*targs, any_hit=any_hit, **mc))
        static_ms, _ = queued_ms(lambda: tc.traverse(*targs, any_hit=any_hit))
        nbytes, ops = motion_work(stats, CHUNK)
        b_ms, b_by = timing.bound_ms(nbytes, ops)
        entries[key] = dict(launches=motion_launches[key], max_abs_err=errs[key], ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        summ = step_summary(stats["lane_steps"], ms)
        summ_u = step_summary(stats_u["lane_steps"])
        log("timing", f"{key}, permuted set of anim-killeroos-moving, {CHUNK} lanes: {ms:.4f} ms "
            f"(plain {plain_ms:.2f} ms with its step counting, host enqueue {host_ms:.4f} ms); "
            f"the static kernel on "
            f"the same lanes (shutter-start rows) {static_ms:.4f} ms; culled walk "
            f"{stats['node_steps']} node + {stats['leaf_steps']} leaf steps, "
            f"{stats['node_rows']} node rows with their deltas and time boxes + "
            f"{stats['leaf_rows']} leaf rows with their deltas, {nbytes} bytes; bound "
            f"{b_ms:.5f} ms ({b_by}), kernel / bound {ms / b_ms:.1f}x; steps per lane mean "
            f"{summ['mean']:.3f}, max {summ['max']} (union walk {summ_u['mean']:.3f}, max "
            f"{summ_u['max']}: {stats_u['node_steps']} node + {stats_u['leaf_steps']} leaf "
            f"steps; plain {union_ms:.2f} ms)")
    fa = ka[1] >= 0
    tie = tie_bvh_motion_equal_plain(dev)
    tie_hits = tie.pop("hits")
    log("kernels", f"motion kernels on {R} rays of anim-killeroos-moving ({R // 2} camera rays "
        f"at their own shutter times, {R - R // 2} bounce rays from {n_hits} first hits), vs "
        f"the union and culled plain walks on the {CHUNK}-lane timed set of them: equal bit for "
        f"bit {eq}; vs the union walk on 1, 7 and 4093 "
        f"lanes {ragged}; closest hits {int((kc[1] >= 0).sum())}, occluded {int(fa.sum())}; "
        f"closest hit vs intersect_brute on the lerped triangles, {BRUTE_LANES} lanes: valid "
        f"equal {bool(torch.equal(kv, bv))}, max rel t diff {brute_rel:.3g}, prim equal on "
        f"{float((kc[1][sel] == hb.prim).float().mean()):.6f}; the tie-and-dense scene with "
        f"motion under the BVH, 4,096 lanes, vs the union walk: {tie} (closest hits {tie_hits})")
    if not (all(eq.values()) and ragged and torch.equal(kv, bv) and brute_rel <= 1e-6
            and all(tie.values()) and tie_hits["copies"] > 0 and tie_hits["cluster"] > 0):
        raise SystemExit("a motion kernel disagrees with its plain version or intersect_brute")
    del built, sets, si, kc, ka, q, qa, o, d, inv, tmin, tmax, tmax_a, tw, film
    torch.cuda.empty_cache()

    # ---- (b) 64 instanced killeroos --------------------------------------
    t0 = time.time()
    bi = build(load_scene_string(instanced_scene_text()), device=dev)
    gi = bi.scene.geometry
    n_obj = gi.num_triangles - 4
    used = geometry_bytes(gi)
    # 64 flattened copies, computed: per copy its triangles' 9 float rows
    # of 3 or 2 and 3 int64 ids, and its table's rows
    per_tri = (6 * 3 + 3 * 2) * 4 + 3 * 8
    flat = (used - n_obj * per_tri - gi.inst_rows.numel() * 4
            + gi.num_instances * (n_obj * per_tri + gi.inst_rows.numel() * 4))
    log("scene", f"64 instanced killeroos: {gi.num_instances} uses of one {n_obj}-triangle "
        f"blob, {gi.inst_rows.shape[0]} BLAS rows (inst_stack {gi.inst_stack}), "
        f"{gi.num_triangles - n_obj} world triangles in {gi.wide_rows.shape[0]} rows; geometry "
        f"tables on the device {used / 2**20:.2f} MiB against {flat / 2**20:.2f} MiB for 64 "
        f"flattened copies (computed: {per_tri} B per triangle, 320 B per row; "
        f"{flat / used:.1f}x); built in {time.time() - t0:.1f} s")
    if gi.num_instances != 64 or n_obj != 20 * 57 ** 2:
        raise SystemExit("the instanced scene did not build 64 uses of one blob")
    film_i, sec_i, li, _ = drive("64 instanced killeroos with path", bi, 1)
    if li["traverse_instances_closest"] == 0 or li["traverse_instances_any"] == 0:
        raise SystemExit("the instanced scene did not launch the instance kernels")
    profile_frame("64 instanced killeroos with path, chunk 0", bi, sec_i * 1e3,
                  run=chunk_wave(bi, dev), scale=chunks_of(bi))

    sets = instance_lane_sets(bi, dev)
    o, d, si, scale = sets["o"], sets["d"], sets["si"], sets["scale"]
    n_hits = int(si.valid.sum())
    R = o.shape[0]
    inv = isect.make_inv_dir(d).contiguous()
    tmin = torch.zeros(R, device=dev)
    tmax = torch.full((R,), float("inf"), device=dev)
    g = gi
    world = tc.traverse(g.wide_rows, g.wide_stack, o, d, inv, tmin, tmax,
                        *walk_seeds(g, o, d, tmin, tmax), any_hit=False)
    itab = (g.inst_rows, g.inst_stack, g.inst_w2o, g.inst_lo, g.inst_hi, g.inst_root)
    ki = tc.traverse_instances(*itab, o, d, inv, tmin, tmax, *world, any_hit=False)
    tmax_a = torch.where(torch.isfinite(ki[0]), ki[0] * scale, 1e30).contiguous()
    world_a = tc.traverse(g.wide_rows, g.wide_stack, o, d, inv, tmin, tmax_a,
                          *walk_seeds(g, o, d, tmin, tmax_a), any_hit=True)
    kia = tc.traverse_instances(*itab, o, d, inv, tmin, tmax_a, *world_a, any_hit=True)
    ragged = True
    for n in (1, 7, 4093):
        cut = lambda xs: [x[:n].contiguous() for x in xs]
        for any_hit, tm, seeds in ((False, tmax, world), (True, tmax_a, world_a)):
            a = cut((o, d, inv, tmin, tm, *seeds))
            ragged &= bits(tc.traverse_instances(*itab, *a, any_hit=any_hit),
                           tc.traverse_instances_plain(*itab, *a, any_hit))
    sync()
    # the plain phase on the timed set only, as the motion walks above
    sub = sets["sub"]
    pick = lambda x: x[sub].contiguous()
    eq, errs = {}, {}
    lib = native.kernel_lib("traverse.cu")
    regs = kernel_registers(lib._name, native.build_log.get("pbrt_torch_traverse"))
    threads = tc.INSTANCE_BLOCK_THREADS
    smem = threads // 8 * max(g.inst_stack, 1) * 4
    for key, any_hit, tm, seeds, kern in (("traverse_instances_closest", False, tmax, world, ki),
                                          ("traverse_instances_any", True, tmax_a, world_a, kia)):
        targs = (*itab, pick(o), pick(d), pick(inv), pick(tmin), pick(tm),
                 *[pick(x) for x in seeds])
        stats, plain = {}, []
        plain_ms = cuda_ms(lambda: plain.append(tc.traverse_instances_plain(*targs, any_hit,
                                                                            stats=stats)),
                           n=1, warm=0)
        ks, ps = [pick(x) for x in kern], plain[0]
        eq[key] = bits(ks, ps) and bits(tc.traverse_instances(*targs, any_hit=any_hit), ps)
        hit = torch.isfinite(ps[0]) if not any_hit else ps[1] >= 0
        errs[key] = float((ks[0][hit] - ps[0][hit]).abs().max()) if hit.any() else 0.0
        ms, host_ms = queued_ms(lambda: tc.traverse_instances(*targs, any_hit=any_hit))
        nbytes = (CHUNK * LANE_BYTES_INSTANCES + g.num_instances * INSTANCE_ROW_BYTES
                  + stats.get("node_rows", 0) * NODE_ROW_BYTES
                  + stats.get("leaf_rows", 0) * LEAF_ROW_BYTES)
        ops = (stats["prunes"] * OPS_PRUNE + stats["walks"] * OPS_INSTANCE_RAY
               + stats.get("node_steps", 0) * OPS_NODE_STEP
               + stats.get("leaf_steps", 0) * OPS_LEAF_STEP)
        b_ms, b_by = timing.bound_ms(nbytes, ops)
        entries[key] = dict(launches=li[key], max_abs_err=errs[key], ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by)
        r = [v for name, v in regs.items() if tc.KERNEL_NAMES[key] in name]
        occ = (f"{r[0]} registers, {blocks_per_sm(r[0], smem, threads)} blocks of {threads} "
               f"threads per SM (occupancy rules, {smem} B of stacks)" if r
               else "registers not reported")
        log("timing", f"{key}, permuted set of the instanced scene, {CHUNK} lanes, "
            f"{g.num_instances} instances: {ms:.4f} ms (plain {plain_ms:.2f} ms with its step "
            f"counting, host enqueue "
            f"{host_ms:.4f} ms); {stats['prunes']} box tests, {stats['walks']} walks, "
            f"{stats.get('node_steps', 0)} node + {stats.get('leaf_steps', 0)} leaf steps, "
            f"{stats.get('node_rows', 0)} node + {stats.get('leaf_rows', 0)} leaf distinct "
            f"rows, {nbytes} bytes, {ops} operations; bound {b_ms:.5f} ms ({b_by}), "
            f"kernel / bound {ms / b_ms:.1f}x; {occ}; {instance_schedule_summary(stats)}")
    n_inst = int((ki[4] >= 0).sum())
    n_inst_set = int((pick(ki[4]) >= 0).sum())
    fa = kia[1] >= 0
    log("kernels", f"instance kernels on {R} rays of the instanced scene ({R // 2} camera rays, "
        f"{R - R // 2} bounce rays from {n_hits} first hits), seeded with the world walk, vs "
        f"plain on the {CHUNK}-lane timed set of them ({n_inst_set} instanced hits): t, prim, "
        f"b1, b2 and inst equal bit for bit {eq}; on 1, 7 and 4093 lanes {ragged}; closest hits "
        f"{int((ki[1] >= 0).sum())}, {n_inst} of them instanced, on "
        f"{len(set(ki[4].tolist())) - 1} distinct uses; occluded {int(fa.sum())}")
    tie = instance_tie_kernels_equal_plain(dev)
    log("kernels", f"instance kernels on the instanced tie scene (3 uses of one box filling one "
        f"footprint, a world triangle on their bottom face; 4096 rays along z): t, prim, b1, "
        f"b2 and inst equal bit for bit to the plain phase {tie['equal']}; closest hits "
        f"{tie['hits']}, held by use 0 {tie['use0']}, by the world triangle {tie['world']}; "
        f"any hit {tie['occluded']} of them occluded")
    if not (all(eq.values()) and ragged and n_inst_set > 0 and all(tie["equal"].values())
            and tie["use0"] > 0 and tie["world"] > 0):
        raise SystemExit("an instance kernel disagrees with its plain version")
    del bi, gi, g, world, world_a, ki, kia, o, d, inv, film_i
    torch.cuda.empty_cache()

    # ---- (d) 16² references ----------------------------------------------
    card_vs_cpu(f"anim-killeroos-moving ({20 * SMALL_BLOB_FREQ ** 2}-triangle blobs)",
                anim_scene_text(SMALL_BLOB_FREQ, res=16), spp=1, chunk_pixels=256,
                waves=TEXTURE_REF_WAVES)
    small = instanced_scene_text(SMALL_BLOB_FREQ, res=16, grid=(4, 2))
    card_vs_cpu(f"8 instanced blobs ({20 * SMALL_BLOB_FREQ ** 2} triangles each)", small,
                spp=1, chunk_pixels=256, waves=TEXTURE_REF_WAVES)
    pair = [build(load_scene_string(t_), device=dev) for t_ in
            (small, instanced_scene_text(SMALL_BLOB_FREQ, res=16, grid=(4, 2), flatten=True))]
    gen.manual_seed(13)
    o, d, _, _, _ = camera_and_bounce_rays(pair[1], dev, 8192, gen, times=False)
    ray = geom.Ray.make(o, d)
    hi, hf = (isect.intersect(b.scene.geometry, ray) for b in pair)
    v = hf.valid
    t_rel = float(((hi.t[v] - hf.t[v]).abs() / hf.t[v]).max())
    films = [np.stack([render(b, spp=1, seed=sd, chunk_pixels=256).pixels.cpu().numpy()
                       for sd in range(TEXTURE_REF_WAVES)]) for b in pair]
    close = float(np.isclose(films[0], films[1], rtol=1e-3, atol=1e-3).all(-1).mean())
    log("reference", f"8 instanced blobs 16x16 against the same scene flattened, on the card: "
        f"8,192 rays hit equal {bool(torch.equal(hi.valid, hf.valid))}, max rel t diff "
        f"{t_rel:.3g} (rtol 2e-4); render(seed=0..{TEXTURE_REF_WAVES - 1}, spp=1) pixels "
        f"close (rtol 1e-3, atol 1e-3) {close:.4f}")
    if not (torch.equal(hi.valid, hf.valid) and t_rel <= 2e-4 and close >= REF_PIXELS):
        raise SystemExit("the instanced scene disagrees with its flattened copy")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "pbrt_torch")):
        print("chip_smoke: pbrt_torch/ is not beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pbrt_torch.accel import intersect as isect
    from pbrt_torch.accel import traverse_cuda as tc
    from pbrt_torch.accel import traverse_kd as tk
    from pbrt_torch.core import geometry as geom
    from pbrt_torch.core import rng
    from pbrt_torch.core import sampling as smp
    from pbrt_torch.film import film as film_mod
    from pbrt_torch.integrators.path import PrimarySource, trace_radiance
    from pbrt_torch.integrators import dipole
    from pbrt_torch.renderers.sampler import (SURFACE_ONLY, camera_noise, integrator_draws,
                                              render, render_wave)
    from pbrt_torch.scene.api import load_scene, load_scene_string
    from pbrt_torch.scene.builder import build
    from pbrt_torch.scripts import gather_lab as gl
    from pbrt_torch.utils import native, timing
    from pbrt_torch.utils.timing import cuda_ms, queued_ms

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize

    # ---- 1. device --------------------------------------------------------
    smi = timing.nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    # every library at once, one compiler process each (the FMA-contracted
    # traversal build is only for the -fmad=false cost measurement below,
    # traverse_kd.cu's variants for phase 14's)
    t0 = time.time()
    builds = [(native.kernel_lib, s, False) for s in native.KERNEL_SOURCES]
    builds.append((native.kernel_lib, "traverse.cu", True))
    # traverse_kd.cu's other-width build, timed beside its kernels in phase 14
    builds += [(native.kernel_lib, "traverse_kd.cu", False, m) for m in tk.VARIANTS.values()]
    with ThreadPoolExecutor(len(builds) + 1) as ex:
        futs = [ex.submit(fn, *a) for fn, *a in builds]
        futs.append(ex.submit(native.bvh_lib))
        for f in futs:
            f.result()
    build_s = time.time() - t0
    log("build", f"{len(builds)} kernel libraries and the SAH builder built in "
        f"{build_s:.1f} s")
    for lib_name, out in sorted(native.build_log.items()):
        for ln in out.splitlines():
            if "registers" in ln or "spill" in ln:
                log("build", f"{lib_name}: {ln.strip()}")
    # the threefry hash's pipe mix: SHF (rotate) and LOP3 (xor) issue to the
    # integer ALU pipe only, IMAD (IMAD.IADD adds) to the FMA pipe, IADD3 to
    # the ALU pipe
    for kname, (n_ins, n_hash, per) in sass_per_hash(native.kernel_lib("rng.cu")._name).items():
        log("build", f"rng.cu {kname} SASS: {n_ins} instructions, {n_hash:g} inlined "
            f"hashes; per hash " + ", ".join(f"{k} {v:.1f}" for k, v in per.items())
            + f" (ALU pipe SHF+LOP3+IADD3 {per['SHF'] + per['LOP3'] + per['IADD3']:.1f}, "
            f"FMA pipe IMAD {per['IMAD']:.1f}, of it IMAD.IADD {per['IMAD.IADD']:.1f})")

    # ---- real-size scene --------------------------------------------------
    t0 = time.time()
    text, n_mesh = real_scene_text()
    built = build(load_scene_string(text), device=dev)
    g = built.scene.geometry
    log("scene", f"{g.num_triangles} triangles ({n_mesh} per generated mesh), "
        f"{g.num_quadrics} sphere(s), {g.wide_rows.shape[0]} wide rows, "
        f"wide_stack {g.wide_stack}, table {g.wide_rows.numel() * 4 / 2**20:.2f} MiB, "
        f"film {built.film_config.xres}x{built.film_config.yres}x"
        f"{built.film_config.n_bins}; built in {time.time() - t0:.1f} s")

    # ---- 3. kernels vs plain ---------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    W, H = built.film_config.xres, built.film_config.yres
    n_cam = N_LANES // 2
    o, d, _, cam, si = camera_and_bounce_rays(built, dev, N_LANES, gen, times=False)
    hits = torch.nonzero(si.valid).squeeze(1)
    inv = isect.make_inv_dir(d).contiguous()
    R = o.shape[0]
    tmin = torch.zeros(R, device=dev)
    tmax = torch.full((R,), float("inf"), device=dev)
    q = [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmax)]
    sync()
    log("kernels", f"{R} lanes: {n_cam} camera rays + {R - n_cam} bounce rays "
        f"({hits.numel()} first hits)")

    rows, ws = g.wide_rows, g.wide_stack
    kc = tc.traverse(rows, ws, o, d, inv, tmin, tmax, *q, any_hit=False)
    sync()
    pc = tc.traverse_plain(rows, ws, o, d, inv, tmin, tmax, *q, any_hit=False)
    sync()
    same_prim = bool(torch.equal(kc[1], pc[1]))
    same_t = bool(torch.equal(kc[0].view(torch.int32), pc[0].view(torch.int32)))
    same_b = all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                 for a, b in zip(kc[2:], pc[2:]))
    fin = torch.isfinite(pc[0])
    err_closest = float((kc[0][fin] - pc[0][fin]).abs().max()) if fin.any() else 0.0
    log("kernels", f"closest-hit kernel vs plain: prim equal {same_prim}, "
        f"t equal bit for bit {same_t}, b1/b2 equal {same_b}, "
        f"hits {int((pc[1] >= 0).sum())}")
    if not (same_prim and same_t and same_b):
        raise SystemExit("closest-hit traversal kernel disagrees with its plain version")

    sel = torch.randperm(R, generator=gen, device=dev)[:BRUTE_LANES]
    rb = geom.Ray.make(o[sel], d[sel])
    hb = isect.intersect_brute(g, rb)
    sync()
    kv, bv = kc[1][sel] >= 0, hb.prim >= 0
    v = bv & kv
    rel = ((kc[0][sel][v] - hb.t[v]).abs() / hb.t[v].abs()).max() if v.any() else torch.tensor(0.0)
    prim_eq = float((kc[1][sel] == hb.prim).float().mean())
    log("kernels", f"closest-hit kernel vs intersect_brute on {BRUTE_LANES} lanes: "
        f"valid equal {bool(torch.equal(kv, bv))}, max rel t diff {float(rel):.3g}, "
        f"prim equal on {prim_eq:.6f} of lanes (rtol 1e-6 on t; prims may differ "
        f"only on exact-t ties)")
    if not torch.equal(kv, bv) or float(rel) > 1e-6 or prim_eq < 0.999:
        raise SystemExit("closest-hit traversal kernel disagrees with intersect_brute")

    # any-hit: shadow-style segments, half of them end before the closest hit
    scale = torch.where(torch.rand(R, generator=gen, device=dev) < 0.5, 0.5, 1.5)
    tmax_a = torch.where(torch.isfinite(pc[0]), pc[0] * scale,
                         torch.full_like(pc[0], 1e30)).contiguous()
    qa = [x.contiguous() for x in isect.quad_best(g, o, d, tmin, tmax_a)]
    ka = tc.traverse(rows, ws, o, d, inv, tmin, tmax_a, *qa, any_hit=True)
    sync()
    pa = tc.traverse_plain(rows, ws, o, d, inv, tmin, tmax_a, *qa, any_hit=True)
    sync()
    any_valid = bool(torch.equal(ka[1] >= 0, pa[1] >= 0))
    any_same = bool(torch.equal(ka[1], pa[1]))
    fa = ka[1] >= 0
    err_any = float((ka[0][fa] - pa[0][fa]).abs().max()) if fa.any() else 0.0
    log("kernels", f"any-hit kernel vs plain: valid equal {any_valid}, prim equal "
        f"{any_same}, occluded lanes {int(fa.sum())}")
    if not any_valid:
        raise SystemExit("any-hit traversal kernel disagrees with its plain version")

    # standalone step on realistic rows: each lane gets the leaf row that
    # holds its closest triangle (or the root row), a mix of t_best values
    rows_np = rows.cpu().numpy()
    is_leaf_row = np.zeros(len(rows_np), bool)
    walk = [0]  # node rows, from the root
    while walk:
        r = rows_np[walk.pop()]
        refs = r[48:56][r[0:8] <= r[8:16]].astype(np.int64)
        walk.extend(refs[refs >= 0].tolist())
        is_leaf_row[-refs[refs < 0] - 1] = True
    tri_row = np.zeros(g.num_triangles, np.int64)
    for r in np.nonzero(is_leaf_row)[0]:
        pid = rows_np[r, 72:80]
        tri_row[pid[pid >= 0].astype(np.int64)] = r
    tri_row_t = torch.as_tensor(tri_row, device=dev)
    is_tri = (pc[1] >= 0) & (pc[1] < g.num_triangles)
    ridx = torch.where(is_tri, tri_row_t[pc[1].clamp(0, g.num_triangles - 1).long()], 0)
    srow = rows[ridx].contiguous()
    s_node = ~torch.as_tensor(is_leaf_row, device=dev)[ridx]
    pick = torch.rand(R, generator=gen, device=dev)
    s_tb = torch.where(pick < 0.5, float("inf"),
                       torch.where(pick < 0.75, pc[0] * 1.25, pc[0])).contiguous()
    s_act = (torch.rand(R, generator=gen, device=dev) < 0.9).contiguous()
    ks = tc.step(srow, o, d, inv, tmin, s_tb, s_node, s_act)
    sync()
    ps = tc.step_plain(srow, o, d, inv, tmin, s_tb, s_node, s_act)
    sync()
    step_ok = {}
    for nm, a, b in zip(("refs", "n_hit", "tsel", "psel", "b1", "b2"), ks, ps):
        step_ok[nm] = bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    fs = torch.isfinite(ps[2])
    err_step = float((ks[2][fs] - ps[2][fs]).abs().max()) if fs.any() else 0.0
    log("kernels", f"standalone step kernel vs plain on {R} lanes "
        f"({int(s_node.sum())} node rows, {int(fs.sum())} leaf hits): "
        f"equal bit for bit {step_ok}")
    if not all(step_ok.values()):
        raise SystemExit("standalone step kernel disagrees with its plain version")
    # ragged launches: lane counts that leave the last warp (4 rays) partly empty
    ragged_ok = True
    for n in (1, 7, 4093):
        cut = lambda xs: [x[:n].contiguous() for x in xs]
        for any_hit in (False, True):
            tm, seeds = (tmax_a, qa) if any_hit else (tmax, q)
            ra = cut((o, d, inv, tmin, tm, *seeds))
            ragged_ok &= all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in
                             zip(tc.traverse(rows, ws, *ra, any_hit=any_hit),
                                 tc.traverse_plain(rows, ws, *ra, any_hit)))
        sa = cut((srow, o, d, inv, tmin, s_tb, s_node, s_act))
        ragged_ok &= all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                         for x, y in zip(tc.step(*sa), tc.step_plain(*sa)))
    sync()
    log("kernels", f"closest-hit, any-hit and step kernels vs plain on 1, 7 and 4093 "
        f"lanes: equal bit for bit {ragged_ok}")
    if not ragged_ok:
        raise SystemExit("a traversal kernel disagrees with its plain version on a ragged launch")

    # ---- timing at the main path's launch width --------------------------
    # two 32,768-lane sets: a random permutation of the mixed rays (the set
    # earlier PRs timed) and a render-order set, as the render launches
    # them: consecutive pixels from the frame's middle, their camera rays,
    # then their first bounces in the same order (camera lane p is pixel p;
    # the bounce lanes follow the camera lanes that hit, in order)
    sub = torch.randperm(R, generator=gen, device=dev)[:CHUNK]
    n_pix = W * H
    hit_pix = si.valid[:n_pix].long()
    first = n_pix // 2 - CHUNK // 4
    lanes_used = torch.cumsum(1 + hit_pix[first:], 0)
    n_win = int(torch.searchsorted(lanes_used, CHUNK)) + 1
    win = torch.arange(first, first + n_win, device=dev)
    bounce_of = n_cam + torch.cumsum(hit_pix, 0) - 1
    ro = torch.cat([win, bounce_of[win[hit_pix[win] > 0]]])[:CHUNK]
    lane_sets = {"permuted": sub, "render-order": ro}
    log("timing", f"render-order set: pixels {first}..{first + n_win - 1} "
        f"({n_win} camera rays, {CHUNK - n_win} first bounces)")

    def set_args(idx):
        pick = lambda x: x[idx].contiguous()
        return dict(o=pick(o), d=pick(d), inv=pick(inv), tmin=pick(tmin),
                    tmax=pick(tmax), tmax_a=pick(tmax_a), q=[pick(x) for x in q],
                    qa=[pick(x) for x in qa])

    times = {}
    for set_name, idx in lane_sets.items():
        a = set_args(idx)
        for key, any_hit in (("traverse_closest", False), ("traverse_any", True)):
            tm, seeds = (a["tmax_a"], a["qa"]) if any_hit else (a["tmax"], a["q"])
            targs = (rows, ws, a["o"], a["d"], a["inv"], a["tmin"], tm, *seeds)
            stats = {}
            tc.traverse_plain(*targs, any_hit, stats=stats)
            ms, host_ms = queued_ms(lambda: tc.traverse(*targs, any_hit=any_hit))
            nbytes = (CHUNK * LANE_BYTES_TRAVERSE + stats["node_rows"] * NODE_ROW_BYTES
                      + stats["leaf_rows"] * LEAF_ROW_BYTES)
            ops = (stats["node_steps"] * OPS_NODE_STEP
                   + stats["leaf_steps"] * OPS_LEAF_STEP)
            b_ms, b_by = timing.bound_ms(nbytes, ops)
            summ = step_summary(stats["lane_steps"], ms)
            plain_txt = ""
            if set_name == "permuted":  # the kernels line's set
                plain_ms = cuda_ms(lambda: tc.traverse_plain(*targs, any_hit), n=3, warm=1)
                times[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
                plain_txt = f" (plain {plain_ms:.2f} ms)"
            log("timing", f"{key}, {set_name} set, {CHUNK} lanes: {ms:.4f} ms{plain_txt} "
                f"(host enqueue {host_ms:.4f} ms); "
                f"{stats['node_steps']} node + {stats['leaf_steps']} leaf steps, "
                f"{stats['node_rows']} node + {stats['leaf_rows']} leaf distinct rows, "
                f"{nbytes} bytes; bound {b_ms:.5f} ms ({b_by}), "
                f"kernel / bound {ms / b_ms:.1f}x")
            log("timing", f"  steps per lane: mean {summ['mean']:.3f}, p99 {summ['p99']:.0f}, "
                f"max {summ['max']}; per-warp max at 32 rays/warp: mean "
                f"{summ['warp32_mean']:.2f}, max {summ['warp32_max']}, lane use "
                f"{100 * summ['use32']:.1f}%; at 4 rays/warp: mean {summ['warp4_mean']:.2f}, "
                f"max {summ['warp4_max']}, lane use {100 * summ['use4']:.1f}%; "
                f"{1e3 * summ['ms_per_longest_step']:.4f} us per step of the longest ray")
    # what -fmad=false costs: the same kernel built with FMA contraction,
    # timed in turns on the same lanes
    perm = set_args(sub)
    pargs = (rows, ws, perm["o"], perm["d"], perm["inv"], perm["tmin"], perm["tmax"],
             *perm["q"])
    fm = [queued_ms(lambda: tc.traverse(*pargs, any_hit=False, fmad=f))[0]
          for f in (False, True, True, False)]
    log("timing", f"traverse_closest -fmad=false vs -fmad=true on {CHUNK} lanes, "
        f"in turns (no-FMA, FMA, FMA, no-FMA): "
        + ", ".join(f"{x:.4f}" for x in fm) + " ms")
    st_args = [x[sub].contiguous() for x in (srow, o, d, inv, tmin, s_tb, s_node, s_act)]
    st_ms, st_host = queued_ms(lambda: tc.step(*st_args))
    st_plain = cuda_ms(lambda: tc.step_plain(*st_args), n=5, warm=1)
    n_node = int(st_args[6].sum())
    st_ops = n_node * OPS_NODE_STEP + (CHUNK - n_node) * OPS_LEAF_STEP
    # an inactive lane's outputs do not depend on its row
    n_act_node = int((st_args[6] & st_args[7]).sum())
    n_act_leaf = int((~st_args[6] & st_args[7]).sum())
    st_bytes = (CHUNK * LANE_BYTES_STEP + n_act_node * NODE_ROW_BYTES
                + n_act_leaf * LEAF_ROW_BYTES)
    st_bound, st_by = timing.bound_ms(st_bytes, st_ops)
    log("timing", f"wide_step on {CHUNK} lanes: {st_ms:.4f} ms (plain {st_plain:.2f} ms, "
        f"host enqueue {st_host:.4f} ms); bound {st_bound:.5f} ms ({st_by})")

    # ---- 4. rng: keyed uniforms and scrambles vs plain ---------------------
    root = rng.root_key(0)
    pix_all = torch.arange(N_LANES, dtype=torch.int64, device=dev)
    rng_eq, err_ku = {}, 0.0
    scr_all = rng.pixel_scrambles(root, pix_all)
    ps_ = rng.pixel_scrambles_plain(root, pix_all)
    rng_eq["scrambles"] = bool(torch.equal(scr_all, ps_))
    err_ks = float((scr_all - ps_).abs().max())
    for sample in (0, 3, 2**31 + 1):
        ku = rng.primary_uniforms(root, pix_all, scr_all, sample, RNG_DEPTH)
        pu = rng.primary_uniforms_plain(root, pix_all, scr_all, sample, RNG_DEPTH)
        rng_eq[f"uniforms s={sample}"] = bool(torch.equal(ku.view(torch.int32),
                                                          pu.view(torch.int32)))
        err_ku = max(err_ku, float((ku - pu).abs().max()))
    err_ao = 0.0
    for sample in (0, 3, 2**31 + 1):
        for n_ao in AO_CHECKED:
            ka = rng.ao_uniforms(root, pix_all, scr_all, sample, n_ao)
            pa = rng.ao_uniforms_plain(root, pix_all, scr_all, sample, n_ao)
            rng_eq[f"ao s={sample} n={n_ao}"] = bool(torch.equal(ka.view(torch.int32),
                                                                 pa.view(torch.int32)))
            err_ao = max(err_ao, float((ka - pa).abs().max()))
            del pa
    sync()
    log("rng", f"keyed kernels vs plain on {N_LANES} lanes (depth {RNG_DEPTH}, "
        f"{ku.shape[1]} columns; AO samples {AO_CHECKED}): equal bit for bit {rng_eq}; "
        f"uniforms in [{float(ku.min()):.3g}, {float(ku.max()):.6g}], mean "
        f"{float(ku.double().mean()):.6f}; AO uniforms ({ka.shape[1]} columns) in "
        f"[{float(ka.min()):.3g}, {float(ka.max()):.6g}], mean {float(ka.double().mean()):.6f}")
    if not all(rng_eq.values()):
        raise SystemExit("a keyed-uniform kernel disagrees with its plain version")
    if not (float(ku.min()) >= 0.0 and float(ku.max()) < 1.0
            and float(ka.min()) >= 0.0 and float(ka.max()) < 1.0):
        raise SystemExit("keyed uniforms outside [0, 1)")
    del ka
    # ragged lane counts, other depths, pixel indices at and above 2**31
    pix_wrap = torch.cat([torch.tensor(PIXELS_WRAP, dtype=torch.int64, device=dev), pix_all])
    n_cases = n_ao_cases = 0
    for n in (1, 7, 31, 33, 4093, 32767):
        pr = pix_wrap[:n].contiguous()
        sr = rng.pixel_scrambles_plain(root, pr)
        if not torch.equal(rng.pixel_scrambles(root, pr), sr):
            raise SystemExit(f"keyed_scrambles disagrees with its plain version on {n} lanes")
        for depth in (0, 1, 4, 5):
            for sample in (0, 3, 2**31 + 1):
                k_ = rng.primary_uniforms(root, pr, sr, sample, depth)
                p_ = rng.primary_uniforms_plain(root, pr, sr, sample, depth)
                if not torch.equal(k_.view(torch.int32), p_.view(torch.int32)):
                    raise SystemExit(f"keyed_uniforms disagrees with its plain version on "
                                     f"{n} lanes, depth {depth}, sample {sample}")
                n_cases += 1
        for n_ao in AO_CHECKED:
            for sample in (0, 3, 2**31 + 1):
                k_ = rng.ao_uniforms(root, pr, sr, sample, n_ao)
                p_ = rng.ao_uniforms_plain(root, pr, sr, sample, n_ao)
                if not torch.equal(k_.view(torch.int32), p_.view(torch.int32)):
                    raise SystemExit(f"keyed_ao_uniforms disagrees with its plain version on "
                                     f"{n} lanes, {n_ao} AO samples, sample {sample}")
                n_ao_cases += 1
    sync()
    log("rng", f"keyed_uniforms on {n_cases} ragged cases (1 to 32,767 lanes, depths 0, 1, "
        f"4, 5, samples 0, 3, 2**31 + 1, pixel indices up to 2**32 - 1), keyed_ao_uniforms "
        f"on {n_ao_cases} ({AO_CHECKED} AO samples) and keyed_scrambles on 6: equal bit "
        f"for bit")
    pix_c, pix_f = pix_all[:CHUNK].contiguous(), pix_all[:n_pix].contiguous()
    scr_c = scr_all[:CHUNK].contiguous()
    # a keyed launch takes microseconds, less than its enqueueing: the
    # spin that queued_ms enqueues the calls behind keeps the host out
    ku_t = timing.queued_rounds(
        lambda: rng.primary_uniforms(root, pix_c, scr_c, 1, RNG_DEPTH), RNG_ROUNDS)
    ka_t = timing.queued_rounds(
        lambda: rng.ao_uniforms(root, pix_c, scr_c, 1, AO_TIMED), RNG_ROUNDS)
    ks_t = timing.queued_rounds(lambda: rng.pixel_scrambles(root, pix_f), RNG_ROUNDS)
    ku_ms, ks_ms = ku_t["ms"], ks_t["ms"]
    ku_plain = cuda_ms(lambda: rng.primary_uniforms_plain(root, pix_c, scr_c, 1, RNG_DEPTH),
                       n=5, warm=1)
    ks_plain = cuda_ms(lambda: rng.pixel_scrambles_plain(root, pix_f), n=5, warm=1)
    ka_ms = ka_t["ms"]
    ka_plain = cuda_ms(lambda: rng.ao_uniforms_plain(root, pix_c, scr_c, 1, AO_TIMED),
                       n=5, warm=1)
    # the function's work: each lane's key once, its 5 camera columns, then
    # 7 uniforms per bounce; bytes: pixel and scramble words in, the row out
    n_u = 7 * RNG_DEPTH
    ku_bound, ku_by = timing.bound_ms(
        CHUNK * (8 + 48 + 4 * (5 + n_u)), f32_ops=CHUNK * (n_u + OPS_CAMERA_F32),
        i32_ops=CHUNK * (OPS_LANE_KEY + n_u * OPS_PER_UNIFORM + OPS_CAMERA_I32))
    ks_bound, ks_by = timing.bound_ms(
        n_pix * (8 + 6 * 8), i32_ops=n_pix * (OPS_LANE_KEY + 6 * OPS_PER_SCRAMBLE))
    # AO: pixel and scramble words in, the (5 + 2n)-float row out; the
    # lane's key, then per AO sample its key and 2 uniforms
    ka_bound, ka_by = timing.bound_ms(
        CHUNK * (8 + 48 + 4 * (5 + 2 * AO_TIMED)),
        f32_ops=CHUNK * (2 * AO_TIMED + OPS_CAMERA_F32),
        i32_ops=CHUNK * (OPS_AO_LANE_KEY + AO_TIMED * OPS_PER_AO_SAMPLE + OPS_CAMERA_I32))
    spread = lambda t: f"{t['min']:.5f}–{t['max']:.5f}"
    log("timing", f"keyed_uniforms (primary-sample array) on {CHUNK} lanes, depth "
        f"{RNG_DEPTH}: median {ku_ms:.5f} ms over {RNG_ROUNDS} rounds ({spread(ku_t)}; plain "
        f"{ku_plain:.3f} ms, host enqueue {ku_t['host_ms']:.4f} ms); bound {ku_bound:.5f} ms "
        f"({ku_by}), kernel / bound {ku_ms / ku_bound:.2f}x")
    log("timing", f"keyed_ao_uniforms (ambient occlusion's array) on {CHUNK} lanes, "
        f"{AO_TIMED} AO samples: median {ka_ms:.5f} ms over {RNG_ROUNDS} rounds "
        f"({spread(ka_t)}; plain {ka_plain:.3f} ms, host enqueue {ka_t['host_ms']:.4f} ms); "
        f"bound {ka_bound:.5f} ms ({ka_by}), kernel / bound {ka_ms / ka_bound:.2f}x")
    log("timing", f"keyed_scrambles on {n_pix} lanes: median {ks_ms:.5f} ms over "
        f"{RNG_ROUNDS} rounds ({spread(ks_t)}; plain {ks_plain:.3f} ms, host enqueue "
        f"{ks_t['host_ms']:.4f} ms); bound {ks_bound:.5f} ms ({ks_by}), kernel / bound "
        f"{ks_ms / ks_bound:.2f}x")

    # ---- 5. small reference: card vs CPU --------------------------------
    rs = np.random.default_rng(5)

    def agree(what, fg, fc, bin_tol=REF_BIN_REL, bands=1):
        """Films of the card and the CPU agree: pixels close (each
        (pixel, band) of ``bands`` equal groups of bins, one traced path of
        the spectral renderer, when ``bands`` > 1) and per-bin means."""
        close = np.isclose(fg, fc, rtol=REF_RTOL, atol=REF_ATOL)
        px_close = float(close.reshape(*close.shape[:-1], bands, -1).all(-1).mean())
        mg, mc = (f.reshape(-1, f.shape[-1]).mean(0) for f in (fg, fc))
        bin_rel = float(np.abs(mg - mc).max() / max(np.abs(mc).max(), 1e-30))
        unit = "pixels" if bands == 1 else "(pixel, band) paths"
        # the lanes behind the gap: the pixels furthest apart, (wave, y, x)
        # with the card's and the CPU's radiance summed over the bins
        gap = np.abs(fg - fc).sum(-1).reshape(-1)
        worst = [(np.unravel_index(i, fg.shape[:-1]), fg.reshape(-1, fg.shape[-1])[i].sum(),
                  fc.reshape(-1, fc.shape[-1])[i].sum()) for i in np.argsort(-gap)[:3]
                 if gap[i] > 0 and not close.reshape(-1, close.shape[-1])[i].all()]
        lanes = "; lanes apart: " + ", ".join(
            f"{tuple(int(v) for v in at)} card {a:.4g} CPU {b:.4g}" for at, a, b in worst
        ) if worst else ""
        log("reference", f"{what}: {unit} close (rtol {REF_RTOL:g}) {px_close:.4f}, "
            f"per-bin mean rel diff {bin_rel:.3g}, equal bit for bit "
            f"{bool(np.array_equal(fg, fc))}{lanes}")
        if (px_close < REF_PIXELS or bin_rel > bin_tol or not np.isfinite(fg).all()
                or not fg.sum() > 0):
            raise SystemExit(f"{what}: the renders disagree")

    def card_vs_cpu(label, text, spp=2, chunk_pixels=40, scene_path=None, waves=1,
                    renderer=render, bin_tol=REF_BIN_REL, bands=1):
        """``waves`` waves, each from one primary-sample array (and a lens
        camera's keyed normals of wave w's seed) on the card and on the
        CPU, then ``renderer``(seed, spp) for seeds 0 to waves − 1 in chunks
        of ``chunk_pixels``, on both, each comparison pooled over its
        waves; the scene is ``text``, or the file ``scene_path``."""
        pair = [build(load_scene(scene_path) if scene_path else load_scene_string(text),
                      device=d) for d in (dev, "cpu")]
        ic, fc = pair[0].integrator, pair[0].film_config
        n_px = fc.xres * fc.yres
        width = (PrimarySource.CAMERA_DIMS + 2 * ic.ao_nsamples
                 if ic.kind == "ambientocclusion" else PrimarySource.n_dims(
                     0 if ic.kind == "metadata" else ic.max_depth))
        # a scene with volumes: the media block, random too
        media_w = (max(ic.max_depth, 1) + (rng.VOLUME_STEPS * rng.PER_VOLUME_STEP
                                           if ic.volume_kind == "single" else 0)
                   if pair[0].scene.has_volumes and ic.kind not in SURFACE_ONLY else 0)
        yy, xx = np.divmod(np.arange(n_px), fc.xres)
        films = [[], [], []]
        for w in range(waves):
            u_np = rs.random((n_px, width), dtype=np.float32)
            m_np = rs.random((n_px, media_w), dtype=np.float32) if media_w else None
            # the scene's own conditioning: the CPU again, each image sample
            # one ulp over (not checked; what an ulp of difference does)
            u_ulp = u_np.copy()
            u_ulp[:, :2] = np.nextafter(u_ulp[:, :2], np.float32(1))
            for slot, (b, u_) in enumerate(((pair[0], u_np), (pair[1], u_np),
                                            (pair[1], u_ulp))):
                st = film_mod.init_film(b.film_config, b.device)
                pix_w = torch.as_tensor(yy * fc.xres + xx, device=b.device)
                render_wave(st, b.scene, b.camera, b.filter_table,
                            torch.as_tensor(xx, device=b.device),
                            torch.as_tensor(yy, device=b.device), b.integrator,
                            b.film_config, torch.as_tensor(u_, device=b.device),
                            noise=camera_noise(b.camera, rng.root_key(w), pix_w, 0),
                            media=None if m_np is None else torch.as_tensor(m_np,
                                                                             device=b.device),
                            draws=integrator_draws(b.scene, b.integrator, rng.root_key(w),
                                                   pix_w, 0))
                films[slot].append(st.pixels.cpu().numpy())
        films = [np.stack(f) for f in films]
        what = f"{label} {fc.xres}x{fc.yres}, {ic.kind}" + (
            f" ({ic.metadata_channel})" if ic.kind == "metadata" else "")
        pooled = f", {waves} waves pooled" if waves > 1 else ""
        own = float(np.isclose(films[2], films[1], rtol=REF_RTOL, atol=REF_ATOL).all(-1).mean())
        m1, m2 = (f.reshape(-1, f.shape[-1]).mean(0) for f in (films[1], films[2]))
        own_bin = float(np.abs(m2 - m1).max() / max(np.abs(m1).max(), 1e-30))
        log("reference", f"{what}{pooled}: the CPU against itself with each image sample one "
            f"ulp over: pixels close (rtol {REF_RTOL:g}) {own:.4f}, per-bin mean rel diff "
            f"{own_bin:.3g}")
        agree(f"{what}, same uniforms{pooled}, card vs CPU", films[0], films[1], bin_tol)
        keyed = [np.stack([renderer(b, spp=spp, seed=sd, chunk_pixels=chunk_pixels)
                           .pixels.cpu().numpy() for sd in range(waves)]) for b in pair]
        seeds = "seed=0" if waves == 1 else f"seed=0..{waves - 1}"
        agree(f"{what}, {renderer.__name__}({seeds}, spp={spp}), card vs CPU", *keyed,
              bin_tol, bands)
        return pair[0], keyed[0][0]

    tiny_gpu, tiny_keyed = card_vs_cpu("tiny scene", TINY_SCENE)
    agree("tiny scene 16x16, path, render(seed=0, spp=2) on the card, chunk_pixels 40 vs 64",
          tiny_keyed, render(tiny_gpu, spp=2, seed=0, chunk_pixels=64).pixels.cpu().numpy())
    for directive in ('"directlighting"', '"whitted"', '"ambientocclusion" "integer nsamples" [4]',
                      '"metadata" "string strategy" ["depth"]',
                      '"metadata" "string strategy" ["mesh_mask"]',
                      '"metadata" "string strategy" ["material_mask"]'):
        card_vs_cpu("tiny scene", TINY_SCENE.replace('"path" "integer maxdepth" [5]', directive))
    small_text, _ = real_scene_text(SMALL_BLOB_FREQ, res=16)
    for kind in ("path", "directlighting"):
        card_vs_cpu(f"lights-and-quadrics scene ({20 * SMALL_BLOB_FREQ ** 2}-triangle blobs)",
                    lights_scene_text(small_text, kind))

    # ---- 6. gather lab ----------------------------------------------------
    lab_in = gl.lab_inputs(dev)
    kg = gl.gather_lab(*lab_in)
    pg = gl.gather_lab_plain(*lab_in)
    sync()
    lab_eq = bool(torch.equal(kg.view(torch.int32), pg.view(torch.int32)))
    err_lab = float((kg - pg).abs().max())
    log("gather_lab", f"kernel vs plain on {gl.R} lanes, {gl.N}-row table: equal bit "
        f"for bit {lab_eq}, finite {bool(torch.isfinite(kg).all())}, "
        f"sum {float(kg.double().sum()):.9g}")
    if not (lab_eq and bool(torch.isfinite(kg).all())):
        raise SystemExit("gather lab kernel disagrees with its plain version")
    n_cases = 0
    for n, r, args in gl.check_cases(dev):
        kc_, pc_ = gl.gather_lab(*args), gl.gather_lab_plain(*args)
        if not (torch.equal(kc_.view(torch.int32), pc_.view(torch.int32))
                and torch.equal(torch.isnan(kc_), args[1].lt(0) | args[1].ge(n))):
            raise SystemExit(f"gather lab kernel disagrees with its plain version on "
                             f"{r} lanes of a {n}-row table")
        n_cases += 1
    sync()
    log("gather_lab", f"kernel vs plain on {n_cases} cases ({gl.CHECK_R} lanes x "
        f"{gl.CHECK_N}-row tables, start indices outside [0, N) at lanes 0, 31 and the "
        f"last): equal bit for bit, NaN exactly there")
    gl.reset_launches()
    lab = gl.main()
    lab_launches = gl.launches["gather_lab"]
    log("gather_lab", f"the lab's path launched the kernel {lab_launches} times and the "
        f"L2 read kernel {gl.launches['l2_read']} times")
    if lab_launches == 0 or gl.launches["l2_read"] == 0:
        raise SystemExit("the gather lab's path did not launch its kernels")

    # ---- 7. the main path -------------------------------------------------
    n_chunks = -(-W * H // CHUNK)

    def drive(label, b, spp, warm=True, renderer=render, bands=1):
        """Renders ``b`` at ``spp`` by ``renderer`` (after one warm-up
        sample) with every launch counter set to 0 just before and read
        just after, and the sampler's torch path counted; checks the film,
        the launches and the .dat round trip. ``bands``: the waves each
        camera sample traces (the spectral renderer's bands), counted as
        camera paths. → (film, seconds, launches, intersect calls)."""
        if warm:
            renderer(b, spp=1, seed=0, chunk_pixels=CHUNK)
            sync()
        tc.reset_launches()
        tk.reset_launches()
        rng.reset_launches()
        dipole.reset_launches()
        for k in isect.calls:
            isect.calls[k] = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        # the sampler's torch path, counted where every camera column would
        # pass, and threefry in torch ops (the samplers' and the media's)
        with mock.patch.object(smp, "camera_uniforms", wraps=smp.camera_uniforms) as cu, \
                mock.patch.object(smp, "_bits_to_unit", wraps=smp._bits_to_unit) as bu, \
                mock.patch.object(rng, "threefry2x32", wraps=rng.threefry2x32) as tf:
            ev[0].record()
            film = renderer(b, spp=spp, seed=0, chunk_pixels=CHUNK)
            ev[1].record()
            sync()
        sampler_calls = {"camera_uniforms": cu.call_count, "_bits_to_unit": bu.call_count,
                         "threefry2x32": tf.call_count}
        # an adaptive render's waves (both passes); else one per sample
        n_waves = film.adaptive["waves"] if film.adaptive else spp
        launches = {**tc.launches, **tk.launches, **rng.launches, **dipole.launches}
        n_calls = isect.calls["intersect"]
        n_inst_calls = isect.calls["instances"]
        sec = ev[0].elapsed_time(ev[1]) / 1e3
        ic = b.integrator
        W, H = b.film_config.xres, b.film_config.yres
        finite = bool(torch.isfinite(film.pixels).all())
        total = float(film.pixels.double().sum())
        with tempfile.TemporaryDirectory() as tmp:
            path = film_mod.write_dat(film, b.film_config, os.path.join(tmp, "out.dat"))
            back, _ = film_mod.read_dat(path)
            dat_ok = bool(np.array_equal(back, film.pixels.cpu().double().numpy()))
        what = {"ambientocclusion": f"{ic.ao_nsamples} AO samples",
                "metadata": f"channel {ic.metadata_channel}"}.get(ic.kind, f"depth {ic.max_depth}")
        traced = f" x {bands} bands" if bands > 1 else ""
        waves_txt = f" ({n_waves} waves)" if film.adaptive else ""
        log("render", f"{label}: {ic.kind}, {W}x{H}, {spp} spp{traced}{waves_txt}, {what}, "
            f"{ic.n_bins} bins, chunk {CHUNK}: {sec:.3f} s, "
            f"{W * H * n_waves * bands / sec:.1f} camera paths/s on {name} ({smi})")
        variants = "".join(f", {k} {launches[k] / spp:.1f}"
                           for k in (*tc.KERNEL_NAMES, *tk.KERNEL_NAMES)
                           if k not in ("wide_step", "traverse_closest", "traverse_any")
                           and launches[k])
        log("render", f"{label}: launches {launches}, intersect calls {n_calls} (with "
            f"instances {n_inst_calls}), per frame (1 spp): closest "
            f"{launches['traverse_closest'] / spp:.1f}, any "
            f"{launches['traverse_any'] / spp:.1f}{variants}, keyed uniforms "
            f"{launches['keyed_uniforms'] / spp:.1f}, keyed AO uniforms "
            f"{launches['keyed_ao_uniforms'] / spp:.1f}, keyed camera normals "
            f"{launches['keyed_camera_normals'] / spp:.1f}, keyed volume uniforms "
            f"{launches['keyed_volume_uniforms'] / spp:.1f}, keyed chain uniforms "
            f"{launches['keyed_chain_uniforms'] / spp:.1f}, mo_gather "
            f"{launches['mo_gather'] / spp:.1f}; film finite {finite}, sum "
            f"{total:.6g}, .dat round trip {dat_ok}; sampler torch ops on the card "
            f"{sampler_calls}")
        keyed = "keyed_ao_uniforms" if ic.kind == "ambientocclusion" else "keyed_uniforms"
        other = "keyed_uniforms" if keyed == "keyed_ao_uniforms" else "keyed_ao_uniforms"
        if not any(launches[k] for k in (*tc.KERNEL_NAMES, *tk.KERNEL_NAMES) if "closest" in k):
            raise SystemExit(f"{label}: the path did not launch a closest-hit traversal")
        if (sum(launches[k] for k in tc.WORLD_KERNELS) != n_calls
                or sum(launches[k] for k in tc.INSTANCE_KERNELS) != n_inst_calls
                or sum(launches[k] for k in tk.KD_KERNELS) != isect.calls["kdtree"]
                or sum(launches[k] for k in tk.GRID_KERNELS) != isect.calls["grid"]):
            raise SystemExit(f"{label}: traversal launches do not match intersect calls")
        noisy = len(b.camera.noise_tags) > 0
        media = b.scene.has_volumes and ic.kind not in SURFACE_ONLY
        per_wave = n_waves * chunks_of(b)
        # igi's VPL picks and the irradiance cache's two gather passes (in a
        # scene with volumes, each pass's nested jitters, and under single
        # scattering their march steps)
        chains = {"igi": 1, "irradiancecache": 4, "diffuseprt": 1, "glossyprt": 1}.get(ic.kind, 0)
        if ic.kind == "irradiancecache" and b.scene.has_volumes:
            chains += 2 * (1 + (ic.volume_kind == "single"))
        if (launches["keyed_scrambles"] != 1 or launches[keyed] != per_wave
                or launches[other] != 0
                or launches["keyed_camera_normals"] != noisy * per_wave
                or launches["keyed_volume_uniforms"] != media * per_wave
                or launches["keyed_chain_uniforms"] != chains * per_wave):
            raise SystemExit(f"{label}: the keyed kernels did not launch once per render "
                             "and once per wave and chunk")
        if not (finite and total > 0.0 and dat_ok):
            raise SystemExit(f"{label}: the film is not finite, empty, or did not round-trip")
        if any(sampler_calls.values()):
            raise SystemExit(f"{label}: the path ran the sampler's torch ops on the card")
        return film, sec, launches, n_calls

    # where the time goes: one more sample of a path under the profiler
    # (not counted above). Only the device's activity is recorded (kernels
    # and copies; host-side events would double the ~350,000 events of a
    # materials-scene frame, whose processing takes minutes); the busy
    # share is taken against the unprofiled frame time, since profiling
    # slows the host
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_frame(label, b, frame_ms, run=None, scale=1):
        """→ {"ms": kernel time, "per_chunk": launches per chunk} of one
        1-spp frame of ``b`` under the profiler; or of ``run``, a part of
        the frame done ``scale`` times in it (one chunk's wave), its times
        and launches multiplied by ``scale``."""
        nc = chunks_of(b)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if run is None:
                render(b, spp=1, seed=3, chunk_pixels=CHUNK)
            else:
                run()
            sync()
        kern = [(e.key, scale * e.self_device_time_total / 1e3, scale * e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        dev_ms = sum(x[1] for x in kern)
        # each traversal kernel's (ms, launches); the closest-hit and the
        # any-hit side each summed over their static, motion and instance
        # kernels, of which the frame must show one at least
        per = {}
        for key, kname in (*tc.KERNEL_NAMES.items(), *tk.KERNEL_NAMES.items()):
            ev = [x for x in kern if kname in x[0]]
            if ev and key != "wide_step":
                per[key] = (sum(x[1] for x in ev), sum(x[2] for x in ev))
        trav = {}
        for side in ("closest", "any"):
            keys = [k for k in per if k.endswith(side) or f"_{side}_" in k]
            if not keys:
                raise SystemExit(f"{label}: the profile shows no {side}-hit traversal event")
            trav["traverse_" + side] = (sum(per[k][0] for k in keys),
                                        sum(per[k][1] for k in keys))
        trav_ms = sum(v[0] for v in trav.values())
        rng_ms = sum(x[1] for x in kern if "keyed_" in x[0])
        n_launch = sum(x[2] for x in kern)
        htod = sum(x[2] for x in kern if x[0].startswith("Memcpy HtoD"))
        part = f" (one wave x {scale})" if scale != 1 else ""
        mo_ms = sum(x[1] for x in kern if "mo_gather" in x[0])
        log("profile", f"{label}, 1 spp{part}: kernel time {dev_ms:.1f} ms in {n_launch} launches "
            f"({n_launch / nc:.1f} per {CHUNK}-lane chunk, {nc} chunks; of them "
            f"{htod} host-to-device copies, none from the sampler) "
            f"= {100 * dev_ms / frame_ms:.1f}% of the unprofiled {frame_ms:.1f} ms "
            f"frame (device idle the rest); traversal kernels {trav_ms:.3f} ms "
            f"({100 * trav_ms / max(dev_ms, 1e-9):.1f}% of kernel time): closest hit "
            f"{trav['traverse_closest'][0]:.3f} ms in {trav['traverse_closest'][1]} launches, "
            f"any hit {trav['traverse_any'][0]:.3f} ms in {trav['traverse_any'][1]} launches "
            f"({', '.join(f'{k} {v[0]:.3f} ms in {v[1]}' for k, v in per.items())}); "
            f"keyed-uniform kernels {rng_ms:.3f} ms, mo_gather {mo_ms:.3f} ms")
        for k, ms_, cnt in sorted(kern, key=lambda x: -x[1])[:8]:
            log("profile", f"  {ms_:8.2f} ms  {cnt:6d}x  {k[:90]}")
        return {"ms": dev_ms, "per_chunk": n_launch / nc, "mo_gather_ms": mo_ms}

    spp = 4
    ic0 = built.integrator
    if (ic0.kind, ic0.max_depth) != ("directlighting", 5):
        raise SystemExit(f"the scene's integrator is {ic0.kind} depth {ic0.max_depth}, "
                         "not killeroo-simple's directlighting at its default depth 5")
    _, sec, launches, _ = drive("killeroo-simple as written", built, spp)
    if launches["traverse_any"] == 0:
        raise SystemExit("directlighting did not launch the any-hit traversal")
    # one chunk's wave scaled to the frame, as phases 9–17 profile (a whole
    # frame's ~50,000 events took the profiler 10–20 s to process)
    prof = profile_frame("killeroo-simple as written (directlighting)", built, sec / spp * 1e3,
                         run=chunk_wave(built, dev), scale=chunks_of(built))
    built_path = dataclasses.replace(built, integrator=dataclasses.replace(ic0, kind="path"))
    _, sec_p, launches_p, _ = drive("killeroo-simple with path", built_path, spp)
    prof_p = profile_frame("killeroo-simple with path", built_path, sec_p / spp * 1e3,
                           run=chunk_wave(built_path, dev), scale=chunks_of(built_path))
    # phase 14 sets its kd-tree and grid frames beside these
    bvh_frames = {"built": built, "directlighting": dict(sec=sec / spp, **prof),
                  "path": dict(sec=sec_p / spp, **prof_p)}
    for key in ("traverse_closest", "traverse_any", "keyed_uniforms", "keyed_scrambles"):
        launches[key] += launches_p[key]

    # ---- 8. the other kinds, and the lights-and-quadrics scene -----------
    for directive in ("whitted", "ambientocclusion", "depth", "mesh_mask", "material_mask"):
        kind = directive if directive in ("whitted", "ambientocclusion") else "metadata"
        b = dataclasses.replace(built, integrator=dataclasses.replace(
            ic0, kind=kind, metadata_channel=directive if kind == "metadata" else "depth"))
        _, _, lk, _ = drive(f"killeroo-simple with {directive}", b, 1, warm=False)
        if kind == "ambientocclusion":
            ao_launches = lk["keyed_ao_uniforms"]
            if lk["traverse_any"] != ic0.ao_nsamples * n_chunks:
                raise SystemExit(f"ambient occlusion launched {lk['traverse_any']} any-hit "
                                 f"traversals, not {ic0.ao_nsamples} per chunk")
    # material ids on the same rays: the card's scene copied to the CPU
    on_cpu = lambda obj: dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})
    scene_cpu = dataclasses.replace(
        built.scene, geometry=on_cpu(g), materials=on_cpu(built.scene.materials),
        lights=on_cpu(built.scene.lights))
    mcfg = dataclasses.replace(ic0, kind="metadata", metadata_channel="material_mask")
    sel = torch.randperm(n_cam, generator=gen, device=dev)[:BRUTE_LANES]
    rays_m = geom.Ray.make(cam.origin[sel].contiguous(), cam.direction[sel].contiguous())
    mg = trace_radiance(built.scene, rays_m, mcfg, None)[0][:, 0].cpu()
    mc = trace_radiance(scene_cpu, geom.Ray.make(rays_m.origin.cpu(), rays_m.direction.cpu()),
                        mcfg, None)[0][:, 0]
    log("kinds", f"material ids of {BRUTE_LANES} camera rays, card vs CPU: equal "
        f"{bool(torch.equal(mg, mc))}, ids seen {sorted(set(mc.int().tolist()))}")
    if not torch.equal(mg, mc) or len(set(mc.int().tolist())) < 3:
        raise SystemExit("metadata's material ids on the card differ from the CPU's")
    lq_text, _ = real_scene_text()
    lq = build(load_scene_string(lights_scene_text(lq_text)), device=dev)
    lqg = lq.scene.geometry
    log("scene", f"lights-and-quadrics scene: {lqg.num_triangles} triangles, quadric types "
        f"{lqg.quad_type.tolist()}, light types {lq.scene.lights.type.tolist()} "
        f"(area lights from row {lq.scene.lights.area_row0})")
    for kind in ("path", "directlighting"):
        b = dataclasses.replace(lq, integrator=dataclasses.replace(lq.integrator, kind=kind))
        drive(f"lights-and-quadrics scene with {kind}", b, 1, warm=False)
    del lq, lqg

    # ---- 9. the materials-and-environment scene ---------------------------
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_materials_")
    try:
        materials_phase(dev, data_dir, drive, profile_frame, card_vs_cpu)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # ---- 10. textures: goldens/metal.pbrt and the texture-kinds scene ------
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_textures_")
    try:
        textures_phase(dev, data_dir, drive, profile_frame, card_vs_cpu)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # ---- 11. motion and instancing ---------------------------------------
    motion_inst = motion_instancing_phase(dev, drive, profile_frame, card_vs_cpu)
    # the static kernels again on phase 3's two sets, after the new ones
    for set_name, idx in lane_sets.items():
        a = set_args(idx)
        line = []
        for key, any_hit in (("traverse_closest", False), ("traverse_any", True)):
            tm, seeds = (a["tmax_a"], a["qa"]) if any_hit else (a["tmax"], a["q"])
            targs = (rows, ws, a["o"], a["d"], a["inv"], a["tmin"], tm, *seeds)
            line.append(f"{key} {queued_ms(lambda: tc.traverse(*targs, any_hit=any_hit))[0]:.4f} ms")
        log("timing", f"static kernels re-timed on phase 3's {set_name} set, {CHUNK} lanes: "
            + ", ".join(line) + f" (phase 3: {times['traverse_closest']['ms']:.4f}, "
            f"{times['traverse_any']['ms']:.4f} ms on the permuted set)")

    # ---- 12. lens cameras and the spectral renderer ---------------------------
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_lens_")
    try:
        normals_entry = lens_phase(dev, drive, profile_frame, card_vs_cpu, data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # ---- 13. samplers and media ------------------------------------------------
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_media_")
    try:
        media_entries = media_phase(dev, data_dir, drive, profile_frame, card_vs_cpu)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # ---- 14. accelerators, refined shapes, goldens/bunny.pbrt ---------------
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_accel_")
    try:
        accel_entries = accelerators_phase(dev, data_dir, drive, profile_frame, card_vs_cpu,
                                           bvh_frames)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    del bvh_frames

    # ---- 15. the preprocess integrators, goldens/ss-envmap.pbrt ------------
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_preprocess_")
    try:
        preprocess_entries = preprocess_phase(dev, data_dir, drive, profile_frame, card_vs_cpu)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # ---- 16. PRT, probes and the Metropolis renderer -----------------------
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_prt_mlt_")
    try:
        mutate_entry = prt_mlt_phase(dev, data_dir, drive, profile_frame, card_vs_cpu, agree)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # ---- 17. differentiable rendering, resume, sharded, tools -------------
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_grad_")
    try:
        grad_launches = grad_phase(dev, data_dir, name, smi)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    for key in ("traverse_closest", "traverse_any", "keyed_uniforms", "keyed_scrambles"):
        launches[key] += grad_launches[key]

    # ---- 18. volumes under the cache, MLT and the gradients ---------------
    fog_launches = fog_phase(dev, drive, profile_frame, card_vs_cpu, agree, name, smi)
    for key in ("traverse_closest", "traverse_any", "keyed_uniforms", "keyed_scrambles"):
        launches[key] += fog_launches[key]
    # the fog is emission's: its media launches go to that row
    rows = {"keyed_volume_uniforms[emission]": "keyed_volume_uniforms",
            "keyed_chain_uniforms": "keyed_chain_uniforms", "mlt_mutate": "mlt_mutate"}
    for entry in (*media_entries, *preprocess_entries, mutate_entry):
        if entry["name"] in rows:
            entry["launches"] += fog_launches[rows[entry["name"]]]

    # ---- 19. kernels line -------------------------------------------------
    src = "pbrt_torch/csrc/traverse.cu"
    rep = "pbrt_tpu/accel/pallas_step.py:36"
    kernels = []
    for key, err in (("traverse_closest", err_closest), ("traverse_any", err_any)):
        kernels.append(dict(
            name=key, route="cuda", source=src, replaces=rep,
            launches=launches[key], max_abs_err=err, library_ms=None, **times[key]))
    for key, rep_, n_, err_, ms_, plain_, b_, by_ in (
            ("keyed_uniforms", "pbrt_tpu/integrators/path.py:116", launches["keyed_uniforms"],
             err_ku, ku_ms, ku_plain, ku_bound, ku_by),
            ("keyed_scrambles", "pbrt_tpu/renderers/sampler.py:44", launches["keyed_scrambles"],
             err_ks, ks_ms, ks_plain, ks_bound, ks_by),
            ("keyed_ao_uniforms", "pbrt_tpu/integrators/path.py:783", ao_launches, err_ao,
             ka_ms, ka_plain, ka_bound, ka_by)):
        kernels.append(dict(
            name=key, route="cuda", source="pbrt_torch/csrc/rng.cu", replaces=rep_,
            launches=n_, max_abs_err=err_, ms=ms_, plain_ms=plain_,
            bound_ms=b_, bound_by=by_, library_ms=None))
    kernels.append(normals_entry)
    kernels.extend(media_entries)
    kernels.append(dict(
        name="gather_lab", route="cuda", source="pbrt_torch/csrc/gather_lab.cu",
        replaces="scripts/pallas_gather_lab.py:78", launches=lab_launches,
        max_abs_err=err_lab, ms=lab["ms"], plain_ms=lab["plain_ms"],
        bound_ms=lab["bound_ms"], bound_by=lab["bound_by"], library_ms=None))
    for key, entry in accel_entries.items():
        kernels.append(dict(
            name=key, route="cuda", source="pbrt_torch/csrc/traverse_kd.cu",
            replaces=("pbrt_tpu/accel/intersect.py:1149" if "_kd_" in key
                      else "pbrt_tpu/accel/intersect.py:1249"), library_ms=None, **entry))
    kernels.extend(preprocess_entries)
    kernels.append(mutate_entry)
    for key, entry in motion_inst.items():
        kernels.append(dict(name=key, route="cuda", source=src, replaces=rep,
                            launches=entry["launches"], max_abs_err=entry["max_abs_err"],
                            ms=entry["ms"], plain_ms=entry["plain_ms"],
                            bound_ms=entry["bound_ms"], bound_by=entry["bound_by"],
                            library_ms=None))
    step_line = dict(
        name="wide_step", route="cuda", source=src, replaces=rep,
        launches=launches["wide_step"], max_abs_err=err_step, ms=st_ms,
        plain_ms=st_plain, bound_ms=st_bound, bound_by=st_by, library_ms=None,
    )
    log("kernels", "library_ms is null: no single PyTorch call computes a BVH "
        "traversal, threefry keyed from (pixel, sample, purpose) (torch's own "
        "generators are Philox / mt19937 streams, another function), or the "
        "lab's gather-and-slab walk; the standalone step is not launched by "
        "the main path (its device function is), so it stands on its own line; "
        "keyed_* replace XLA's threefry at the file:line given, not a Pallas "
        "kernel; the traversal's and keyed_uniforms' launches are those of the "
        "directlighting and path renders (4 spp each), of phase 17's gradient "
        "path (value_and_grads and grad_wrt_materials on the 512² path frame, "
        "two passes each) and of phase 18's fog runs (its irradiancecache frame, "
        "three Metropolis frames and three value_and_grads), keyed_ao_uniforms' those "
        "of the ambient-occlusion render (1 spp); the motion kernels' launches are "
        "those of goldens/anim-killeroos-moving.pbrt as written (8 spp), "
        "keyed_camera_normals' those of the D-Gauss spectral frame and the "
        "ideal-diffraction frame (1 spp each; torch.randn's Philox is another "
        "function), keyed_uniforms[sampler]'s those of phase 13's frame with "
        "that sampler (1 spp; adaptive's, not listed, its two 8-wave frames), "
        "keyed_volume_uniforms' those of the water frame (single scattering) "
        "and [emission]'s those of the fog frame (1 spp each) and of phase 18's "
        "fog runs, the "
        "instance kernels' those of the 64 instanced killeroos (1 spp), each "
        "timed on its own scene's permuted set, its plain_ms one call of the "
        "plain version, which counts the work for the bound as it goes; the "
        "kd-tree's and grid's kernels (XLA while_loops in the JAX package, "
        "intersect.py:1149 and :1249, no Pallas kernel) their killeroo "
        "directlighting and path frames' (1 spp each), their motion twins those "
        "of the motion scene's frame under each (1 spp); "
        "mo_gather's (XLA's fori_loop and einsum in the JAX package) those of "
        "goldens/ss-envmap.pbrt's 64-spp frame, two a call (the lane list and the "
        "gather; its ms is the call's, both kernels), keyed_chain_uniforms' (XLA's "
        "threefry) those of phase 15's igi and irradiancecache frames and of "
        "phase 18's (the fog's cache frame, AO's Metropolis directions, igi's "
        "gradient; the preprocess launches, at build, are logged apart); "
        "mlt_mutate's (XLA's threefry and the Kelemen step, metropolis.py:73) "
        "those of phase 16's two Metropolis frames and phase 18's three (8 "
        "iterations and the bootstrap's block each); "
        "gather_lab's launches are "
        "those of the lab's own path")
    print("step " + json.dumps(step_line), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
