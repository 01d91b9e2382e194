"""Build the port's CUDA kernels from ``src/repro_torch/csrc`` and load them.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` process per source, all started together), linked into
``libreprotorch_kernels.so`` under ``build/repro_torch/<key>/`` at the repo
root, and loaded with ``ctypes``. ``<key>`` hashes the sources and the
flags, so a rebuild happens only when either changes. The library has a
plain C interface: pointers and the stream go in as ``c_void_p``, and each
entry point returns ``cudaGetLastError()``.

The build raises if ``nvcc`` is missing or fails; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libreprotorch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the library's entry points (see csrc/*.cu)
SIGNATURES = {
    # q, k, v, o, lse, B, T, S, H, KV, D, causal, window, dtype, scale, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _P),
    # q, k, v, valid, o, B, S, H, KV, D, dtype, scale, splits, stream
    "decode_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                             _I, _P),
    # q, k, v, o, do, lse, aux, dq, dk, dv, B, T, S, H, KV, D, causal,
    # window, dtype, scale, stream
    "flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # h, w, targets, logp_old, adv, mask, partials, N, D, V, dtype, sigma,
    # stream
    "policy_loss_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # h, w, targets, logp_old, adv, mask, coefs, dh, dlogits (f32 scratch),
    # dw (w's dtype), N, D, V, dtype, sigma, stream
    "policy_loss_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _F, _P),
    # N, D, V, dtype -> rows of d a rank of K4's tensor-core body takes (0:
    # the FMA body)
    "policy_loss_slice": (_I, _I, _I, _I),
    # N, D, V, dtype -> rows of the partial sums policy_loss_fwd writes
    "policy_loss_partial_rows": (_I, _I, _I, _I),
    # logits, targets, logp_old, adv, mask, partials, N, V, dtype, sigma,
    # stream
    "gipo_head_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # logits, targets, logp_old, adv, mask, coefs, dlogits, N, V, dtype,
    # sigma, stream
    "gipo_head_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # N, V, dtype -> lanes a row of K5's register body (0: the streaming
    # body), token rows a partial row sums, rows of the partial sums
    # gipo_head_fwd writes
    "gipo_head_lanes": (_I, _I, _I),
    "gipo_head_block_rows": (_I, _I, _I),
    "gipo_head_partial_rows": (_I, _I, _I),
    # x, dt, A, Bm, Cm, y, s_final, s_enter (may be null), B, L, H, P, N,
    # chunk, dtype, stream
    "ssd_scan_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _P),
    # the same, on the FMA body whatever the dtype and shape
    "ssd_scan_fwd_fma": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _P),
    # P, N, chunk, dtype -> 1 if ssd_scan_fwd runs the tensor-core body
    "ssd_scan_fwd_tc_body": (_I, _I, _I, _I),
    # x, dt, A, Bm, Cm, s_enter, dy, ds_final, dx, ddt, da_part, da,
    # db_part, dc_part, db, dc, B, L, H, P, N, chunk, dtype, stream
    "ssd_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "repro_cuda_error_string": (_I,),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: compiler output of the build this process ran ("" if it reused one)
build_log = ""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
            / "bin" / "nvcc"
        if cand.is_file():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA kernels cannot be built")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _key() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_dir: pathlib.Path) -> str:
    """Compile every .cu in parallel, then link. Returns the compiler log."""
    nvcc = find_nvcc()
    cus = sorted(CSRC.glob("*.cu"))
    procs = []
    for cu in cus:
        obj = out_dir / (cu.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu),
               "-o", str(obj)]
        procs.append((cu, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cu, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {cu.name}\n{out}")
        if p.returncode != 0:
            failed.append(cu.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    lib_tmp = out_dir / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(lib_tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    os.replace(lib_tmp, out_dir / LIB_NAME)
    return "\n".join(log)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_log
    if _lib is not None:        # every launch asks: skip the lock then
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / _key()
        lib_path = out_dir / LIB_NAME
        if not lib_path.is_file():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT))
            try:
                log = _compile(tmp)
                (tmp / "build.log").write_text(log)
                try:
                    os.replace(tmp, out_dir)
                except OSError:      # another process finished first
                    pass
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            build_log = log
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = (ctypes.c_char_p if name == "repro_cuda_error_string"
                          else ctypes.c_int)
        _lib = lib
        return lib


def check(err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().repro_cuda_error_string(err).decode()
        if err == 1:                      # cudaErrorInvalidValue
            msg += (" (a shape the kernel refuses, or a block that needs "
                    "more shared memory than the H100's 227 KB)")
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")
