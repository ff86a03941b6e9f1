"""Build and load the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, bound with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into
``build/repro_torch_kernels/lib<name>-<hash>.so`` at the repository root;
the hash covers the sources and flags, so an edited kernel rebuilds and an
unchanged one is reused.  :func:`build` compiles every missing library at once, one ``nvcc``
process per source, all started together.

Nothing here falls back: a missing ``nvcc``, a failed compile or a non-zero
``cudaGetLastError()`` from a launch raises.  The tiled dense products (K1,
K2) take their launch plan from :func:`tiled_plan`: how K is split over the
grid so that the blocks fill the card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("boolmm", "minplus", "spmv", "relax", "flash_attention",
           "flash_attention_bwd", "rglru_scan", "rglru_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: launches per kernel wrapper: each wrapper adds one where it launches its
#: kernel, and nowhere else
LAUNCHES = {"bool_matmul": 0, "minplus_matmul": 0, "maxplus_matmul": 0,
            "csr_bool_step": 0, "csr_minplus_step": 0, "csr_maxplus_step": 0,
            "csr_plustimes_step": 0, "csr_minplus_tiled_step": 0,
            "relax_step": 0, "relax_step_tiled": 0, "flash_attention": 0,
            "flash_attention_f32": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_f32": 0, "rglru_scan": 0,
            "rglru_scan_bwd": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the repro_torch "
                       "CUDA kernels are built from source at first use")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        if f.suffix == ".cuh" or f.stem == name:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> str:
    """Compile every library in ``names`` that is not built yet, in parallel,
    and return the compiler's report.  ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel; it does not change the
    code)."""
    extra = ("-Xptxas", "-v") if verbose else ()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    logs, failed = [], []
    for n, (proc, tmp, p) in procs.items():
        log, _ = proc.communicate()
        logs.append(f"== {n}.cu ==\n{log}")
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, p)
    report = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{report}")
    return report


def load(name: str, prototypes: dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with ``argtypes``
    set from ``prototypes`` and ``restype`` int on each entry point."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            for fn, argtypes in prototypes.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def on_card(what: str, *tensors) -> bool:
    """Route a wrapper call: False when every tensor lies on the CPU (the
    plain version runs), True when all lie on one CUDA device (the kernel
    launches).  Anything else raises — a CUDA tensor never reaches the plain
    version through a wrapper."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return True
    raise ValueError(f"{what}: operands must all lie on the CPU or all on one "
                     f"CUDA device, got {sorted(map(str, devs))}")


def require(what: str, t, dtype, ndim: int) -> None:
    """Check what a kernel takes: dtype, rank and a contiguous layout."""
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {ndim}-D {dtype} tensor, got "
            f"{tuple(t.shape)} {t.dtype} (contiguous={t.is_contiguous()})")


#: streaming multiprocessors of the H100 SXM: the split plans' default
SMS = 132
#: a block's fill and drain, in k stages, in :func:`split_k`'s cost
SPLIT_OVERHEAD = 2


def split_k(tiles: int, stages: int, slots: int) -> tuple[int, int]:
    """How many K ranges to cut a tiled product into so that its blocks
    fill the card: ``tiles`` output tiles, ``stages`` k stages in all,
    ``slots`` blocks the card runs at once.  Returns ``(splits, per)``,
    ``per`` stages a split (``splits = ceil(stages / per)``), minimizing the
    waves of blocks times the stages each runs plus
    :data:`SPLIT_OVERHEAD`; the fewest splits on a tie.  Tiles that fill
    two waves alone are not split: each split would add a partial per
    output to combine and gain a wave's tail at most."""
    stages = max(1, stages)
    if tiles >= 2 * slots:
        return 1, stages
    best = None
    for s in range(1, stages + 1):
        per = -(-stages // s)
        splits = -(-stages // per)
        if best is not None and splits == best[1]:
            continue
        cost = -(-(tiles * splits) // slots) * (per + SPLIT_OVERHEAD)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of a tiled product with K split over the grid: split
    ``s`` takes k in ``[s·k_chunk, min(k, (s+1)·k_chunk))``; ``scratch`` is
    the shape of the splits' partials where the kernel keeps them (else
    ``()``); ``vec`` is the aligned ``cp.async`` route, else the predicated
    loads."""
    splits: int
    k_chunk: int
    grid: tuple[int, int, int]
    scratch: tuple[int, ...]
    vec: bool


def tiled_plan(m: int, k: int, n: int, tile: tuple[int, int, int],
               blocks_per_sm: int, sms: int, partials: bool,
               vec: bool) -> Plan:
    """The :class:`Plan` of an (m, k) ⊗ (k, n) product in ``tile`` =
    (rows, columns, k a stage) blocks, ``blocks_per_sm`` at once on each of
    ``sms`` SMs; ``partials``: more than one split needs an (splits, m, n)
    scratch."""
    bm, bn, bk = tile
    tiles_n, tiles_m = -(-n // bn), -(-m // bm)
    splits, per = split_k(tiles_m * tiles_n, -(-k // bk), sms * blocks_per_sm)
    return Plan(splits, per * bk, (tiles_n, tiles_m, splits),
                (splits, m, n) if partials and splits > 1 else (), vec)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of ``device`` (a CUDA device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned(*tensors) -> bool:
    """Every tensor's data starts on a 16-byte boundary (``cp.async``'s)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def stream_handle(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream
