"""Build, load and launch-check the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process (all started together)
for ``sm_90a`` into an object file, then linked into one shared library with
a plain C interface that ctypes loads.  The library lands in
``treelearn_tpu_torch/_build/<hash>/`` keyed by a hash of the sources and
flags, so editing a kernel rebuilds it and an unchanged tree reuses the
build.  Nothing here runs at import time: the first wrapper that launches a
kernel on a CUDA tensor triggers the build.

Every C launcher returns ``cudaGetLastError()``; :func:`check` raises on a
nonzero code.  Each wrapper adds one to ``LAUNCHES[name]`` where it launches
its kernel, so a run can show which kernels the main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
import time

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC = osp.join(_PKG, "csrc")
BUILD_ROOT = osp.join(_PKG, "_build")
SOURCES = ("rulebook.cu", "subm_conv.cu", "subm_conv_wgmma.cu",
           "subm_conv_tf32.cu", "subm_conv_dw.cu", "subm_conv_dw_wgmma.cu",
           "subm_conv_dw_tf32.cu", "vert.cu", "cc.cu", "knn.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"rulebook": 0, "subm_conv": 0, "subm_conv_wgmma": 0,
            "subm_conv_tf32": 0, "subm_conv_dw": 0, "subm_conv_dw_wgmma": 0,
            "subm_conv_dw_tf32": 0, "vert": 0, "cc": 0, "knn": 0}

# optional observer of kernel inputs: recorder(name, args_dict)
_RECORDER = None

_lib = None
_build_info: dict = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # keys, V, sx, sy, sz, rule, stream
    "tl_rulebook": [_P, _I, _I, _I, _I, _P, _P],
    "tl_rulebook_probes": [_P, _I, _I, _I, _I, _P, _P],
    # feats, weight, rule, out, v_in, v_out, n_live, cin, cout, n_offsets,
    # stream
    "tl_subm_conv_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tl_subm_conv_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # w, wpack, cin, cout, bn, n_offsets, mirror, stream
    "tl_pack_weight": [_P, _P, _I, _I, _I, _I, _I, _P],
    # feats, wpack, rule, out, v_out, n_live, cin, cout, n_offsets, bm, bn,
    # stages, producers, smem_bytes, stream
    "tl_subm_conv_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    # w, wpack, cin, cout, bn, sk, n_offsets, mirror, stream
    "tl_pack_weight_tf32": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # feats, wpack, rule, out, v_out, n_live, cin, cout, n_offsets, bn, sk,
    # stages, smem_bytes, stream
    "tl_subm_conv_tf32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # x, g, rule, partial, dw, v, cin, cout, n_offsets, bn, stages, n_chunks,
    # rows_per_chunk, smem_bytes, stream
    "tl_subm_conv_dw_tf32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    # x, g, rule, partial, dw, v, cin, cout, n_offsets, n_chunks, stream
    "tl_subm_conv_dw_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tl_subm_conv_dw_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # refs4, q, ranges, items, n_items, r2, moments, stream
    "tl_vert_moments": [_P, _P, _P, _P, _I, _F, _P, _P],
    # refs, q, q_cell, cell_start, nq, ni, nj, r2, moments, stream
    "tl_vert_moments_serial": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    # pts, cell_keys, cell_start, cell_box, items, n_items, n_cells, width,
    # eps2, out, stream
    "tl_cc_found_bits": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    # pts, cell_ij, cell_keys, cell_start, n, n_cells, width, eps2, out, stream
    "tl_cc_found_bits_serial": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    # x, g, rule, partial, dw, v, cin, cout, n_offsets, bn, producers,
    # stages, n_chunks, rows_per_chunk, smem_bytes, stream
    "tl_subm_conv_dw_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _P],
    # refs4, q, ranges, items, n_items, k, winner, n_found, stream
    "tl_knn_vote": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    # refs, labels, q, ranges, nq, k, winner, n_found, stream
    "tl_knn_vote_serial": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def set_recorder(fn) -> None:
    """Install (or with None remove) an observer called with each kernel
    wrapper's inputs just before it launches; chip_smoke.py uses it to
    replay the main path's own shapes against the plain versions."""
    global _RECORDER
    _RECORDER = fn


def record(name: str, **args) -> None:
    if _RECORDER is not None:
        _RECORDER(name, args)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if osp.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(osp.join(CSRC, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
    return h.hexdigest()[:16]


def _compile(build_dir: str) -> dict:
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in SOURCES:
        obj = osp.join(build_dir, src.replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", osp.join(CSRC, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    ptxas, objs, errors = {}, [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        ptxas[src] = out
        if p.returncode != 0:
            errors.append(f"{src}:\n{out}")
        objs.append(obj)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = osp.join(build_dir, f"libtl_kernels.{os.getpid()}.so")
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs, "-lcudart"],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
    os.replace(tmp, osp.join(build_dir, "libtl_kernels.so"))
    return {"build_s": time.time() - t0, "ptxas": ptxas, "cached": False}


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib, _build_info
    with _lock:
        if _lib is not None:
            return _lib
        build_dir = osp.join(BUILD_ROOT, _source_hash())
        so = osp.join(build_dir, "libtl_kernels.so")
        if osp.exists(so):
            _build_info = {"build_s": 0.0, "ptxas": {}, "cached": True}
        else:
            os.makedirs(build_dir, exist_ok=True)
            _build_info = _compile(build_dir)
        lib = ctypes.CDLL(so)
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _lib = lib
        return _lib


def build_info() -> dict:
    """Seconds the build took and each source's ``-Xptxas -v`` report."""
    library()
    return dict(_build_info)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: error {code}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype=None, ndim=None) -> None:
    """Wrapper-side checks shared by every kernel: CUDA, dtype, rank,
    contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if dtype is not None and t.dtype not in (
            dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype} not supported")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
