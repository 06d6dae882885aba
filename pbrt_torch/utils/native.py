"""Builds and loads the port's native libraries (ctypes, plain C ABI).

One library per source, each built by one compiler call at first use into
``pbrt_torch/_build/`` (listed in ``.gitignore``) and named by a hash of
its source and flags, so an edit rebuilds and a stale library is never
loaded. Different libraries build concurrently (``chip_smoke.py`` starts
them all at once):

- ``libpbrt_torch_bvh-<hash>.so`` — the SAH builder (``csrc/bvh_builder.cpp``),
  compiled with the same ``g++ -O3 -march=native -shared -fPIC`` flags as
  the JAX package's runtime so the two packages build the same tree;
- ``libpbrt_torch_<stem>-<hash>.so`` — the CUDA kernels of one of
  ``KERNEL_SOURCES`` (``csrc/traverse.cu``, ``csrc/rng.cu``,
  ``csrc/traverse_kd.cu``, ``csrc/dipole.cu``, ``csrc/gather_lab.cu``),
  compiled by ``nvcc``
  for ``sm_90a``.

A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: nvcc flags for the kernels: Hopper with its architecture-specific
#: features, IEEE float arithmetic with no FMA contraction (the kernels'
#: float results equal the plain PyTorch versions bit for bit)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_vp, _ci, _u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
#: the keyed kernels' five per-launch sampler constants
_f5 = (ctypes.c_float,) * 5
#: each kernel source's entry points and their ctypes argument types (every
#: pointer and the stream as ``c_void_p``); each returns ``cudaGetLastError()``
#: (``pbrt_torch_max_stack`` its stack cap)
KERNEL_ENTRIES = {
    "traverse.cu": {
        "pbrt_torch_wide_step": [_vp] * 14 + [_ci, _vp],
        "pbrt_torch_traverse_closest": [_vp] * 14 + [_ci, _ci, _vp],
        "pbrt_torch_traverse_any": [_vp] * 14 + [_ci, _ci, _vp],
        "pbrt_torch_traverse_closest_motion": [_vp] * 17 + [_ci, _ci, _vp],
        "pbrt_torch_traverse_any_motion": [_vp] * 17 + [_ci, _ci, _vp],
        "pbrt_torch_traverse_instances_closest": [_vp] * 5 + [_ci] + [_vp] * 14
        + [_ci, _ci, _vp],
        "pbrt_torch_traverse_instances_any": [_vp] * 5 + [_ci] + [_vp] * 14
        + [_ci, _ci, _vp],
        "pbrt_torch_max_stack": [],
    },
    "rng.cu": {
        "pbrt_torch_keyed_uniforms": [_u32, _u32, _vp, _vp, _ci, _u32, _ci, _ci, *_f5,
                                      _vp, _vp],
        "pbrt_torch_keyed_ao_uniforms": [_u32, _u32, _vp, _vp, _ci, _u32, _ci, _ci, *_f5,
                                         _vp, _vp],
        "pbrt_torch_keyed_volume_uniforms": [_u32, _u32, _vp, _ci, _u32, _ci, _ci, _vp, _ci,
                                             _vp, _vp],
        "pbrt_torch_keyed_scrambles": [_u32, _u32, _vp, _ci, _vp, _vp],
        "pbrt_torch_keyed_camera_normals": [_u32, _u32, _vp, _ci, _u32, _u32, _ci]
        + [_u32] * 6 + [_vp, _vp],
        "pbrt_torch_keyed_camera_normals_rows": [_u32, _u32, _vp, _ci, _u32, _u32, _ci, _vp,
                                                 _vp],
        "pbrt_torch_keyed_chain_uniforms": [_u32, _u32, _vp, _ci, _u32, _vp, _ci, _vp, _ci,
                                            _vp, _vp],
        "pbrt_torch_mlt_mutate": [_u32] * 10 + [_vp, _ci, _ci, ctypes.c_float, ctypes.c_float,
                                  ctypes.c_float, _vp, _ci, _vp, _vp, _vp, _vp],
        "pbrt_torch_flat_uniforms": [_u32, _u32, _ci, _ci, _vp, _vp],
    },
    "traverse_kd.cu": {
        **{f"pbrt_torch_traverse_kd_{k}": [_vp] * 10 + [_ci] + [_vp] * 3 + [_ci]
           + [_vp] * 10 + [_ci, _vp]
           for k in ("closest", "any", "closest_motion", "any_motion")},
        **{f"pbrt_torch_traverse_grid_{k}": [_vp] * 6 + [_ci] * 3 + [_vp] * 2 + [_ci]
           + [_vp] * 3 + [_ci] + [_vp] * 10 + [_ci, _vp]
           for k in ("closest", "any", "closest_motion", "any_motion")},
        "pbrt_torch_traverse_kd_info": [ctypes.c_char_p, _vp],
    },
    "dipole.cu": {
        "pbrt_torch_mo_gather": [_vp] * 6 + [_ci] * 3 + [_vp] * 4,
        "pbrt_torch_mo_gather_info": [_vp],
        "pbrt_torch_mo_fast_path_check": [_u32, _u32] + [_ci] * 5 + [_vp, _vp],
    },
    "gather_lab.cu": {
        "pbrt_torch_gather_lab": [_vp] * 5 + [_ci, _ci, _vp],
        "pbrt_torch_l2_read": [_vp, _ci, _ci, _vp, _ci, _vp],
    },
}
KERNEL_SOURCES = tuple(KERNEL_ENTRIES)

#: one lock per library, so different libraries build concurrently
_locks = collections.defaultdict(threading.Lock)
_libs: dict = {}
#: (source, fmad, defines) → its loaded library: every wrapper asks for its
#: library on every launch, so a hit is one dict lookup, no name, no lock
_loaded: dict = {}
#: compiler output of each library built in this process, by library name
#: (for the kernels, ptxas' register / spill report)
build_log: dict = {}


def _digest(path, flags) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(name: str, source: str, compiler: list, flags: list) -> str:
    src = os.path.join(CSRC, source)
    so = os.path.join(BUILD_DIR, f"lib{name}-{_digest(src, flags)}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = compiler + flags + ["-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    build_log[name] = proc.stdout + proc.stderr
    os.replace(tmp, so)
    return so


def check_tensor(name: str, x, dtype, shape, device):
    """Raises unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel reading its raw pointer assumes."""
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_launch(rc: int, what: str):
    """Raises on the ``cudaGetLastError()`` code a kernel entry returns."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def bvh_lib():
    """The SAH builder library (g++)."""
    with _locks["bvh"]:
        if "bvh" not in _libs:
            so = _compile("pbrt_torch_bvh", "bvh_builder.cpp", ["g++"],
                          GXX_FLAGS)
            lib = ctypes.CDLL(so)
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int32)
            lib.pbrt_torch_build_bvh.restype = ctypes.c_int
            lib.pbrt_torch_build_bvh.argtypes = [
                fp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                fp, fp, ip, ip, ip, ip, ctypes.c_int,
            ]
            _libs["bvh"] = lib
        return _libs["bvh"]


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda)")
    return cand


def kernel_lib(source: str, fmad: bool = False, defines: tuple = ()):
    """The library of the CUDA kernels in ``csrc/<source>`` (nvcc, sm_90a),
    built on first call, with its entry points bound.

    ``fmad=True`` builds a second copy with FMA contraction allowed, only to
    measure what ``-fmad=false`` costs; its floats differ from the plain
    versions by rounding. ``defines`` (macro names) build another copy
    with ``-D`` each, only to measure a variant the source offers (e.g.
    ``traverse_kd.cu``'s ``PBRT_KD_OTHER_WIDTH``)."""
    key = (source, fmad, tuple(defines))
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    name = ("pbrt_torch_" + source.removesuffix(".cu") + ("_fmad" if fmad else "")
            + "".join("_" + d.lower() for d in defines))
    with _locks[name]:
        if name not in _libs:
            flags = [f.replace("-fmad=false", "-fmad=true") if fmad else f
                     for f in NVCC_FLAGS] + [f"-D{d}" for d in defines]
            lib = ctypes.CDLL(_compile(name, source, [nvcc_path()], flags))
            for entry, argtypes in KERNEL_ENTRIES[source].items():
                fn = getattr(lib, entry)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _libs[name] = lib
        _loaded[key] = _libs[name]
        return _libs[name]
