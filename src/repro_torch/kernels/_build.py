"""Building, loading and launching the port's CUDA kernels.

The sources under ``repro_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` at first use: one ``nvcc`` process per source, all started
together, then one link into a shared library with a plain C interface
that ``ctypes`` loads. The library goes to ``build/kernels/<hash>/`` at
the root of the checkout (listed in ``.gitignore``), keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once. Nothing is built when a module is imported.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0.
``LAUNCHES`` counts the launches of each kernel: a wrapper adds one
where it launches its kernel and nowhere else.

    python -m repro_torch.kernels._build [BUILD_LOG]

prints the registers and spills of every kernel instance, from the given
``build.log`` or from the library it builds or loads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
_LIF = [_F] * 8 + [_I]          # decay_v .. v_threshold, arp_steps
SIGNATURES = {
    # v, c, refrac, cur -> v', c', refrac', spikes; n; constants; stream
    "repro_lif_step": [_P] * 8 + [_L] + _LIF + [_P],
    # spikes, w, out, rows (B * C), B, N, silent-block counter (or NULL),
    # shared bytes, stream
    "repro_synapse_matmul": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    # tbl, idx, w, out, rows (B * C), B, w rows, N, T, K; the plan (path,
    # CTAs, shared bytes, CTAs a cluster, tenant groups); claim counter;
    # stream
    "repro_ell_gather": [_P, _P, _P, _P] + [_I] * 11 + [_P, _P],
    # s_loc, w, tbl, idx, rem_w, ext, v, c, refrac -> v', c', refrac',
    # spikes; rows (B * C), B, w rows, rem_w rows, N, T, K; constants;
    # silent-block counter; x_pre, x_post -> x_pre', x_post' (or NULL);
    # dp, dm; flags (or NULL); v_floor, v_ceil; the plan (as above);
    # claim counter; stream
    "repro_fused_step": ([_P] * 13 + [_I] * 7 + _LIF + [_P] + [_P] * 4
                         + [_F] * 2 + [_P] + [_F] * 2 + [_I] * 5 + [_P] * 2),
    # w, x_pre_exc, spk_exc, spikes, x_post -> w'; C, N; active (or NULL),
    # columns per tenant; a_plus, a_minus, lr, w_max; stream
    "repro_stdp_dense_update": ([_P] * 6 + [_I] * 2 + [_P, _I] + [_F] * 4
                                + [_P]),
    # tbl, idx, w, spikes, x_post -> w'; rows (B * C), B, w rows; active
    # (or NULL); N, T, K; a_plus, a_minus, lr, w_max; staged, CTAs, shared
    # bytes; stream
    "repro_stdp_remote_update": ([_P] * 6 + [_I] * 3 + [_P] + [_I] * 3
                                 + [_F] * 4 + [_I] * 3 + [_P]),
    # col_ids -> counts, currents; C, N; seed word, t; lam, j_ext; stream
    "repro_keyed_drive": [_P] * 3 + [_I] * 2 + [_U] * 2 + [_F] * 2 + [_P],
    # col_ids -> counts, currents; B, C, N; seeds (B,), the seed's
    # stream; steps, rates (B,); j_ext; stream
    "repro_keyed_drive_tenants": ([_P] * 3 + [_I] * 3 + [_P, _U] + [_P] * 2
                                  + [_F, _P]),
}

# the ELL kernels count their wide path (kernels/plan.py) apart
LAUNCHES = {"lif_step": 0, "synapse_matmul": 0, "ell_gather": 0,
            "ell_gather.wide": 0, "fused_step": 0, "fused_step.wide": 0,
            "stdp_dense_update": 0, "stdp_remote_update": 0,
            "stdp_remote_update.wide": 0, "keyed_drive": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an earlier build was loaded
    log: str                 # nvcc's output (ptxas register/spill report)


_LIBRARY: KernelLibrary | None = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    return None


def _compile(out_dir: Path) -> tuple[Path, str]:
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels of repro_torch are built with the CUDA toolkit on the "
            "machine that has the card")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib_tmp),
             *(str(obj) for _src, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(lib_tmp, out_dir / LIB_NAME)     # atomic publish
        return out_dir / LIB_NAME, "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> KernelLibrary:
    """The loaded kernel library, built from the sources on first use.
    Raises when it cannot be built or loaded: there is no fallback."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out_dir = BUILD_ROOT / source_hash()
    path = out_dir / LIB_NAME
    t0 = time.perf_counter()
    if path.is_file():
        log_file = out_dir / "build.log"
        log = log_file.read_text() if log_file.is_file() else ""
        seconds = 0.0
    else:
        path, log = _compile(out_dir)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _LIBRARY = KernelLibrary(lib, path, seconds, log)
    return _LIBRARY


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers and spill bytes (stores + loads) of each kernel instance,
    by mangled name, from nvcc's ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[name]["spill_bytes"] = int(m[1]) + int(m[2])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[name]["registers"] = int(m[1])
    return out


def check_args(kernel: str, device: torch.device, **args) -> None:
    """Raise unless every ``name=(tensor, dtype, shape)`` has that dtype
    and shape, is contiguous and lies on ``device``, a CUDA device."""
    for name, (t, dtype, shape) in args.items():
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, the kernel "
                            f"takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
    if device.type != "cuda":
        raise ValueError(f"{kernel}: the kernel takes CUDA tensors (or CPU "
                         f"tensors for its plain version), got {device}")


def plan_args(p) -> tuple[int, ...]:
    """A plan as the ELL kernels' C entry points take it: path, CTAs,
    shared bytes, CTAs a cluster, tenant groups."""
    return (p.path_code, p.ctas, p.smem_bytes, p.cluster, p.groups)


def launch(kernel: str, c_name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``c_name`` on ``device``'s current stream,
    raise if the launch failed, and count it."""
    lib = library().lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, c_name)(*args, stream)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    LAUNCHES[kernel] += 1


def main(argv: list[str]) -> int:
    log = Path(argv[0]).read_text() if argv else library().log
    for name, info in ptxas_report(log).items():
        print(f"{info.get('registers', '?'):>4} registers "
              f"{info.get('spill_bytes', '?'):>4} spill bytes  {name}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
