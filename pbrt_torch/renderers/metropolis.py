"""``Renderer "metropolis"``: primary-sample-space MLT with many chains
(port of ``pbrt_tpu/renderers/metropolis.py``; reference:
src/renderers/metropolis.{h,cpp}).

Each of ``n_chains`` chains (16,384, as in the JAX package; not a scene
parameter) is one lane: its primary-sample vector u (D columns), its
radiance L, luminance I and image position. ``_eval_paths`` traces a
batch of vectors: the camera ray from columns 0–4 (u₀·W, u₁·H, lens,
time; a lens camera's noise keyed by the chain's key), then the
bidirectional estimator (``integrators/bdpt.py``, D = ``n_dims_bidir``;
the default) or the scene's surface integrator (D = 5 + 7·depth), the
radiance cleaned of NaN, infinite and negative values.

``render_metropolis``:
1. the bootstrap: nb = min(max(``bootstrapsamples``, n_chains), 131,072)
   vectors ``uniform(fold_in(key(seed), 1), (nb, D))`` traced in chunks
   of ``CHUNK`` (vector i keyed by chain i mod n_chains), b = mean I; a
   black bootstrap gives a black film;
2. the chains start at ``np.random.default_rng(seed).choice(nb,
   n_chains, p=I / ΣI)``, on the host (``seed_chains``);
3. n_iters = max(1, W·H·mpp // n_chains) steps (``mlt_step``): mutate
   every chain (``rng.mutate``: one ``mlt_mutate`` launch with the keys of
   ``fold_in(key(seed), 1000 + it)``), trace, splat the candidate with
   weight a / I_new and the current state with (1 − a) / I (expected
   values, a = min(I_new / I, 1)) into the nearest pixel (out-of-image
   splats dropped), then accept where the accept uniform < a;
4. the film is the splat × b / (n_chains · n_iters / (W·H)), weight 1.

Kept as the JAX package has it: ``samplesperpixel`` (default 100; / 16
under ``quick``) sets the mutations per pixel and ``spp`` is ignored;
``dodirectseparately`` is never read; the splat is nearest-pixel with no
filter. The splat's additions (``index_add_``) come in no fixed order on
the card.

Keyed draws come from each chain's fixed key ``pixel_sample_key(root_key(
seed + 7), chain, 0)`` (metropolis.py:112-114), not from the mutated
vector: the media block (``media_uniforms``: NEE's transmittance jitter,
the camera segment's, single scattering's steps), so a chain keeps one
jitter for all its iterations (ROADMAP fact 51); the integrator's draws
(``integrator_draws``); and, under the unidirectional estimator, every
column past the camera's of the kinds the JAX package dispatches before
it reads a primary sample (``KEYED_KINDS``: ambient occlusion's
directions, the cache's and the probes' directlighting traces, which
``key_uniforms`` draws as ``BatchedKeySource`` does). Metadata reads the
camera columns only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pbrt_torch.core import rng
from pbrt_torch.core import spectrum as spec
from pbrt_torch.film import film as film_mod
from pbrt_torch.integrators.bdpt import n_dims_bidir, trace_bidir
from pbrt_torch.integrators.path import PrimarySource, trace_radiance
from pbrt_torch.renderers.sampler import (camera_noise, integrator_draws, key_uniforms,
                                          media_uniforms)

#: the JAX package's chain count (metropolis.py:87)
N_CHAINS = 16384
#: lanes traced at once in the bootstrap
CHUNK = 1 << 15
#: the largest bootstrap (metropolis.py:117)
MAX_BOOTSTRAP = 1 << 17
#: the chains' key seed offset (metropolis.py:110), the bootstrap's fold-in
#: (:118) and the iterations' (:164)
CHAIN_SEED, BOOTSTRAP_TAG, ITERATION_TAG = 7, 1, 1000
#: the kinds that the JAX ``trace_radiance`` dispatches before it reads a
#: primary sample (path.py:388-407) and whose port reads the array's bounce
#: or AO columns: under unidirectional MLT those columns come from the
#: chains' keys (metadata and the PRT kinds read none)
KEYED_KINDS = ("ambientocclusion", "irradiancecache", "useprobes")


@dataclasses.dataclass
class MLTOptions:
    """The renderer's parameters (metropolis.py:89-106)."""

    mutations_per_pixel: int = 100
    p_large: float = 0.25
    n_bootstrap: int = 100000
    bidirectional: bool = True

    @staticmethod
    def of(built, quick: bool = False) -> "MLTOptions":
        p = built.renderer_params
        if p is None:
            o = MLTOptions()
        else:
            o = MLTOptions(p.find_one_int("samplesperpixel", 100),
                           p.find_one_float("largestepprobability", 0.25),
                           p.find_one_int("bootstrapsamples", 100000),
                           p.find_one_bool("bidirectional", True))
        if quick:
            o = dataclasses.replace(o, mutations_per_pixel=max(1, o.mutations_per_pixel // 16))
        return o


@dataclasses.dataclass
class ChainState:
    """Every chain's vector, radiance, luminance and image position, and
    the splat so far."""

    u: torch.Tensor  # (N, D)
    L: torch.Tensor  # (N, S)
    I: torch.Tensor  # (N,)
    px: torch.Tensor  # (N,)
    py: torch.Tensor  # (N,)
    splat: torch.Tensor  # (H, W, S)
    accepted: torch.Tensor  # () the acceptances so far


def n_dims(built, bidirectional: bool) -> int:
    D = built.integrator.max_depth
    return n_dims_bidir(D) if bidirectional else PrimarySource.n_dims(D)


def _eval_paths(built, u, index, bidirectional: bool, seed: int):
    """Traces the vectors u (N, D), lane k keyed by chain ``index[k]`` →
    (L (N, S), I (N,), px, py) (metropolis.py:52-70). The media block and
    the integrator's draws come from the chains' keys (the module
    docstring)."""
    cfg, icfg, scene = built.film_config, built.integrator, built.scene
    root = rng.root_key(seed + CHAIN_SEED)
    px = u[:, 0] * cfg.xres
    py = u[:, 1] * cfg.yres
    rays = built.camera.generate_rays(px, py, u[:, 2], u[:, 3], u[:, 4],
                                      noise=camera_noise(built.camera, root, index, 0))
    media = media_uniforms(scene, icfg, root, index, 0)
    if bidirectional:
        L, _ = trace_bidir(scene, rays, icfg, u, media=media)
    else:
        if icfg.kind in KEYED_KINDS:
            keyed = key_uniforms(icfg, root, index, 0)
            u = torch.cat([u[:, :PrimarySource.CAMERA_DIMS],
                           keyed[:, PrimarySource.CAMERA_DIMS:]], -1)
        L, _ = trace_radiance(scene, rays, icfg, u, media=media,
                              draws=integrator_draws(scene, icfg, root, index, 0))
    L = torch.where(torch.isnan(L) | torch.isinf(L) | (L < 0.0), 0.0, L)
    return L, spec.luminance(L), px, py


def seed_chains(I_boot: np.ndarray, seed: int, n_chains: int) -> np.ndarray:
    """The bootstrap vectors the chains start from, picked ∝ I on the host
    (metropolis.py:126-128) → (n_chains,) indices."""
    probs = np.maximum(np.asarray(I_boot), 0.0)
    probs = probs / probs.sum()
    return np.random.default_rng(seed).choice(len(probs), n_chains, p=probs)


def bootstrap(built, opts: MLTOptions, seed: int = 0, n_chains: int = N_CHAINS,
              chunk: int = CHUNK):
    """The bootstrap → (b, the chains' start state), or (b, None) for a
    black scene (metropolis.py:115-130)."""
    cfg, dev = built.film_config, built.device
    D = n_dims(built, opts.bidirectional)
    nb = min(max(opts.n_bootstrap, n_chains), MAX_BOOTSTRAP)
    root = rng.root_key(seed)
    u_boot = rng.flat_uniforms(rng.fold_in(root, BOOTSTRAP_TAG), nb, D, dev)
    I_boot = torch.cat([
        _eval_paths(built, u_boot[c0:c0 + chunk],
                    torch.arange(c0, min(c0 + chunk, nb), device=dev) % n_chains,
                    opts.bidirectional, seed)[1]
        for c0 in range(0, nb, chunk)])
    b = float(I_boot.mean())
    if not b > 0.0:
        return b, None
    sel = torch.as_tensor(seed_chains(I_boot.cpu().numpy(), seed, n_chains), device=dev)
    u = u_boot[sel]
    L, I, px, py = _eval_paths(built, u, torch.arange(n_chains, device=dev),
                               opts.bidirectional, seed)
    splat = torch.zeros((cfg.yres, cfg.xres, cfg.n_bins), dtype=torch.float32, device=dev)
    return b, ChainState(u, L, I, px, py, splat, torch.zeros((), dtype=torch.int64, device=dev))


def _splat_into(splat, px, py, L, w):
    """Nearest-pixel splats of w · L, those outside the image dropped
    (metropolis.py:147-159)."""
    H, W, S = splat.shape
    xi = torch.floor(px).to(torch.int64)
    yi = torch.floor(py).to(torch.int64)
    inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    w = torch.where(inside, w, 0.0)
    pix = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
    splat.view(H * W, S).index_add_(0, pix, w[:, None] * L)


def mlt_step(built, st: ChainState, it: int, opts: MLTOptions, seed: int = 0):
    """One iteration of every chain (metropolis.py:161-186): mutate,
    trace, splat both states by their expected weights, accept or reject.
    Updates ``st`` in place and returns it."""
    keys = rng.mutate_keys(rng.fold_in(rng.root_key(seed), ITERATION_TAG + it))
    u_new, _, u_acc = rng.mutate(st.u, keys, opts.p_large)
    index = torch.arange(st.u.shape[0], device=st.u.device)
    L_new, I_new, px_new, py_new = _eval_paths(built, u_new, index, opts.bidirectional, seed)
    a = torch.clamp(I_new / torch.clamp(st.I, min=1e-12), 0.0, 1.0)
    w_new = torch.where(I_new > 0.0, a / torch.clamp(I_new, min=1e-12), 0.0)
    w_old = torch.where(st.I > 0.0, (1.0 - a) / torch.clamp(st.I, min=1e-12), 0.0)
    _splat_into(st.splat, px_new, py_new, L_new, w_new)
    _splat_into(st.splat, st.px, st.py, st.L, w_old)
    accept = u_acc < a
    st.u = torch.where(accept[:, None], u_new, st.u)
    st.L = torch.where(accept[:, None], L_new, st.L)
    st.I = torch.where(accept, I_new, st.I)
    st.px = torch.where(accept, px_new, st.px)
    st.py = torch.where(accept, py_new, st.py)
    st.accepted += accept.sum()
    return st


def render_metropolis(built, spp=None, seed: int = 0, quick: bool = False,
                      n_chains: int = N_CHAINS, chunk: int = CHUNK, stats: dict | None = None):
    """The MLT film (metropolis.py:86-199); ``spp`` is ignored. ``stats``
    (a dict) receives b, the bootstrap's and the chains' seconds, the
    iterations, the acceptance rate, the dimensions, the options and the
    chains' last state."""
    opts = MLTOptions.of(built, quick)
    cfg = built.film_config
    n_pixels = cfg.xres * cfg.yres
    n_iters = max(1, n_pixels * opts.mutations_per_pixel // n_chains)
    t0 = time.perf_counter()
    b, st = bootstrap(built, opts, seed, n_chains, chunk)
    t1 = time.perf_counter()
    state = film_mod.init_film(cfg, built.device)
    if st is not None:
        for it in range(n_iters):
            mlt_step(built, st, it, opts, seed)
        state.pixels = st.splat * (b / (n_chains * n_iters / n_pixels))
        state.weight = torch.ones_like(state.weight)
    if stats is not None:
        acc = float(st.accepted) / (n_chains * n_iters) if st is not None else 0.0
        stats.update(b=b, bootstrap_s=t1 - t0, chains_s=time.perf_counter() - t1,
                     iterations=n_iters, acceptance=acc, dims=n_dims(built, opts.bidirectional),
                     options=opts, state=st)
    return state
