"""Parity of the port's gather lab (``pbrt_torch/scripts/gather_lab.py``, the
plain version of ``csrc/gather_lab.cu``) with the JAX lab script
``scripts/pallas_gather_lab.py``: its XLA step at the lab's full size and
its Pallas kernel body in interpret mode, bit for bit (the port sums the 8
slots in the order XLA's CPU backend does), and the LCG walk against int32
arithmetic. The CUDA kernels cannot run here: their shape constants are
read from ``csrc/gather_lab.cu`` as text, and the plain versions of the
card's ragged cases and of the L2 read ceiling are checked."""

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pbrt_torch.scripts import gather_lab as gl

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "pallas_gather_lab.py"
SOURCE = pathlib.Path(gl.__file__).resolve().parent.parent / "csrc" / "gather_lab.cu"


@pytest.fixture(scope="module")
def lab():
    """The JAX lab script as a module. Importing it sets jax's compilation
    cache directory; the setting is restored right after."""
    saved = jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location("pallas_gather_lab", SCRIPT)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    return mod


def _same_floats(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.int32),
                                  np.asarray(b, np.float32).view(np.int32))


def test_constants_match_script(lab):
    assert (gl.N, gl.R, gl.ITERS) == (lab.N, lab.R, lab.ITERS)


def test_plain_matches_xla_step(lab):
    """The script's own inputs at its full size: 16,384 rows, 32,768 lanes."""
    tab, idx, o, inv = gl.lab_inputs("cpu")
    before = dict(gl.launches)
    out = gl.gather_lab(tab, idx, o, inv)
    assert gl.launches == before  # CPU tensors take the plain version
    ref = lab.xla_step(*(jnp.asarray(a.numpy()) for a in (tab, idx, o, inv)))
    assert np.isfinite(out.numpy()).all() and float(out.abs().sum()) > 0
    _same_floats(out.numpy(), ref)


def test_plain_matches_pallas_body_interpret(lab):
    """The Pallas kernel body (``pallas_loop_kernel``) in interpret mode on
    512 lanes in blocks of 256; the body reads the script's N, so the table
    has exactly 16,384 rows."""
    r, blk = 512, 256
    tab, idx, o, inv = gl.lab_inputs("cpu", seed=1, r=r)
    f = pl.pallas_call(
        lab.pallas_loop_kernel,
        out_shape=jax.ShapeDtypeStruct((r,), jnp.float32),
        grid_spec=pl.GridSpec(
            grid=(r // blk,),
            in_specs=[pl.BlockSpec((lab.N, 80), lambda i: (0, 0)),
                      pl.BlockSpec((blk,), lambda i: (i,)),
                      pl.BlockSpec((blk, 3), lambda i: (i, 0)),
                      pl.BlockSpec((blk, 3), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((blk,), lambda i: (i,)),
            scratch_shapes=[pltpu.VMEM((blk, 80), jnp.float32)],
        ),
        interpret=True,
    )
    ref = f(*(jnp.asarray(a.numpy()) for a in (tab, idx, o, inv)))
    _same_floats(gl.gather_lab_plain(tab, idx, o, inv).numpy(), ref)


@pytest.mark.parametrize("n", [16384, 1000, 7])
def test_lcg_walk_equals_int32(n):
    """``lcg_next`` is ``(cur * 1103515245 + 12345) % n`` in int32 with
    wraparound and floor-mod, as jnp computes it."""
    cur_j = jnp.asarray(np.random.default_rng(2).integers(0, n, 4096), jnp.int32)
    cur_t = torch.as_tensor(np.asarray(cur_j).astype(np.int64))
    for _ in range(12):
        cur_j = (cur_j * 1103515245 + 12345) % n
        cur_t = gl.lcg_next(cur_t, n)
        np.testing.assert_array_equal(cur_t.numpy(), np.asarray(cur_j).astype(np.int64))


def test_out_of_range_start_gives_nan():
    tab, idx, o, inv = gl.lab_inputs("cpu", seed=3, n=64, r=8)
    idx[2], idx[5] = -1, 64
    out = gl.gather_lab_plain(tab, idx, o, inv)
    assert torch.isnan(out).tolist() == [i in (2, 5) for i in range(8)]


def _cu_int(name):
    m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+);", SOURCE.read_text())
    assert m, f"{name} not found in gather_lab.cu"
    return int(m.group(1))


def test_kernel_shape_is_the_plain_versions():
    """gather_lab.cu's row width, slab columns and rounds, read from the
    source as text, are the plain version's."""
    assert (_cu_int("kRow"), _cu_int("kSlab"), _cu_int("kIters")) == (gl.ROW, gl.SLAB, gl.ITERS)


def test_check_cases_put_nan_where_the_start_is_outside():
    """Every ragged case the card holds the kernel at: the plain version
    gives NaN exactly at lane 0, lane 31 and the last lane, finite values
    elsewhere, r values each."""
    cases = list(gl.check_cases("cpu"))
    assert [(n, r) for n, r, _ in cases] == [(n, r) for n in gl.CHECK_N for r in gl.CHECK_R]
    for n, r, (tab, idx, o, inv) in cases:
        out = gl.gather_lab(tab, idx, o, inv)
        assert out.shape == (r,) and tab.shape == (n, gl.ROW)
        bad = [0] + ([31] if r > 31 else []) + ([r - 1] if r > 1 else [])
        assert torch.nonzero(torch.isnan(out)).flatten().tolist() == bad
        assert bool(torch.isfinite(out[~torch.isnan(out)]).all())


def test_l2_read_plain_xors_every_read():
    """The L2 ceiling's plain version against numpy: thread g xors the four
    words of rows (g + k * threads) mod n16 for k < reads."""
    words = torch.as_tensor(np.random.default_rng(4).integers(-2**31, 2**31, (37, 4)),
                            dtype=torch.int32)
    reads, threads = 9, 50
    w = words.numpy()
    ref = np.zeros(threads, np.int32)
    for g in range(threads):
        for k in range(reads):
            j = (g + k * threads) % 37
            ref[g] ^= w[j, 0] ^ w[j, 1] ^ w[j, 2] ^ w[j, 3]
    before = dict(gl.launches)
    np.testing.assert_array_equal(gl.l2_read(words, reads, threads).numpy(), ref)
    assert gl.launches == before  # CPU tensors take the plain version
    assert gl.SLAB_BYTES == gl.R * 8 * 192 == 50_331_648


def test_work_counts_the_walk():
    """Every row of the lab's table is touched; bytes and operations as
    the bound counts them."""
    _, idx, _, _ = gl.lab_inputs("cpu")
    w = gl.work(idx, gl.N)
    assert w["rows_touched"] == gl.N
    assert w["bytes"] == gl.N * 48 * 4 + gl.R * 32 == 4_194_304
    assert w["ops"] == gl.R * 8 * 8 * 25
