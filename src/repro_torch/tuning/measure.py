"""Timing harness for dispatch-table candidates of the port (the
measurement half of KLARAPTOR-style calibration).

Given a compiled dispatch table (:mod:`repro_torch.artifacts.compile`),
this module re-runs the top-k pre-ranked candidates of every data-shape
bucket as *actual kernels* — ``family.instantiate(plan, assignment,
device)`` — and records a trimmed-mean time per candidate.  On ``"cuda"``
the timer reads device time on the card (:class:`DeviceTimer`); on
``"cpu"`` it runs the kernels' plain versions under the host clock, which
smokes the code path and says nothing of the card.

Invariants:

- **deterministic inputs** — operand tensors are drawn from a
  ``torch.Generator`` on the timer's device seeded by ``(family, bucket,
  cfg.seed)``, so two runs time identical work;
- **measurement never invents candidates** — only entries already present
  in the table (hence already feasibility-checked offline) are timed;
- **failure is data, not an error** — a candidate that fails to instantiate
  or run records ``us=None`` and keeps its symbolic rank; the sweep
  continues (the cache-miss-never-error policy, applied to measurement).
  Nothing falls back: a candidate that fails on the card is never run on
  the CPU.

The calibration layer treats the times as an opaque monotone cost, so a
CPU smoke and a card run differ in numbers, not code paths.
"""
from __future__ import annotations

import math
import re
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..core.plan import FamilySpec, KernelPlan
from ..device import device_error

_BUCKET_PART = re.compile(r"^([A-Za-z_]+?)(\d+)$")


def parse_bucket_key(key: str) -> Dict[str, int]:
    """Inverse of :func:`repro_torch.artifacts.dispatch.bucket_key`.

    Relies on the repo-wide convention that data-parameter names contain no
    trailing digits (``M``, ``N``, ``K``, ``SQ``, ``HD``, ``STATE``); the
    bucket grammar is ``<name><pow2>`` joined by ``|``.
    """
    out: Dict[str, int] = {}
    for part in key.split("|"):
        m = _BUCKET_PART.match(part)
        if m is None:
            raise ValueError(f"unparseable bucket part {part!r} in {key!r}")
        out[m.group(1)] = int(m.group(2))
    return out


def clamp_data(data: Mapping[str, int], max_dim: int) -> Dict[str, int]:
    """Clamp each dim to ``max_dim`` (keeps powers of two powers of two)."""
    return {k: min(int(v), max_dim) for k, v in data.items()}


# Per family: the smallest data dims at which a set of candidate assignments
# runs in its real blocking regime: every block extent fits inside its data
# dim, and for K1 every split-K block gets at least one ``bk`` tile (an
# empty split would time a kernel that does less than the bucket's).  Each
# family's format check (``format_error`` of K1-K3) refuses nothing at a
# clamped shape above these floors: its limits only bound the dims from
# above.
def _block_minima(family_name: str,
                  assignments: Sequence[Mapping[str, int]]
                  ) -> Dict[str, int]:
    req: Dict[str, int] = {}

    def need(dim: str, value: int) -> None:
        req[dim] = max(req.get(dim, 1), int(value))

    for a in assignments:
        if family_name == "matmul_h100":
            need("M", a["bm"]); need("N", a["bn"])
            need("K", a["bk"] * a.get("kb", 1))
        elif family_name == "matmul_experts_h100":
            need("M", a["bm"]); need("N", a["bn"]); need("K", a["bk"])
        elif family_name in ("matadd_h100", "transpose_h100"):
            need("M", a["bm"]); need("N", a["bn"] * a["s"])
        elif family_name == "jacobi1d_h100":         # a window of F sweeps
            need("N", a["B"] * a["s"] + 2 * a["F"])
        elif family_name == "flash_attention_h100":
            need("SQ", a["bq"])
        elif family_name == "flash_attention_bwd_h100":
            need("SQ", max(a["bq"], a["bkv"]))
        elif family_name in ("ssd_scan_h100", "ssd_scan_bwd_h100"):
            need("SQ", a["chunk"])
    return req


#: Dims that are a kernel's layout, not its size: a head's width, the query
#: group and the KV heads of K2, the head width and state of K3.  A clamp
#: never touches them (measuring a 64-wide head for a 128-wide bucket would
#: time another tile shape).
_LAYOUT_DIMS = {"flash_attention_h100": ("HD", "GROUP", "HK"),
                "flash_attention_bwd_h100": ("HD", "GROUP", "HK"),
                "ssd_scan_h100": ("HD", "STATE"),
                "ssd_scan_bwd_h100": ("HD", "STATE")}


def measure_shape(family_name: str, data: Mapping[str, int],
                  assignments: Sequence[Mapping[str, int]],
                  max_dim: int) -> Dict[str, int]:
    """The shape a bucket is measured at: dims clamped to ``max_dim``, but
    never below the block extents of the candidates being compared, and
    layout dims (:data:`_LAYOUT_DIMS`) never clamped.

    A clamp keeps a CPU smoke and the monitor's probes cheap; below a
    candidate's block extent it would rank candidates by padding waste the
    bucket never pays, so each dim is floored at the candidates' block
    minima.  A bucket whose true dims are already below a block extent is
    measured verbatim (that padding is what serving pays).  A card run sets
    ``max_dim`` high enough to make this a no-op.
    """
    req = _block_minima(family_name, assignments)
    fixed = _LAYOUT_DIMS.get(family_name, ())
    return {k: int(v) if k in fixed else
            min(int(v), max(max_dim, req.get(k, 1)))
            for k, v in data.items()}


@dataclass(frozen=True)
class MeasureConfig:
    iters: int = 3          # timed repeats per candidate
    warmup: int = 1         # untimed runs after the candidate's first launch
    trim: int = 1           # repeats dropped from each end before the mean
    max_dim: int = 256      # clamp_data bound for measured shapes
    top_k: int = 8          # candidates measured per bucket (prefix of table)
    seed: int = 0           # base seed (mixed with family+bucket)
    device: str = "cuda"    # "cuda": the kernels; "cpu": their plain versions


@dataclass
class MeasuredSample:
    """One (bucket, candidate) timing — the unit calibrate/compact consume."""

    bucket: str
    entry_index: int                  # position in the bucket's symbolic list
    leaf_index: int
    assignment: Dict[str, int]
    score: float                      # symbolic model score (from the table)
    data: Dict[str, int]              # the (possibly clamped) measured shape
    us: Optional[float]               # trimmed-mean microseconds; None=failed
    repeats: List[float] = field(default_factory=list)


def _seed_for(family_name: str, bucket: str, base: int) -> int:
    return zlib.crc32(f"{family_name}|{bucket}|{base}".encode()) & 0x7FFFFFFF


#: Keys K2 is timed over and (row, head) pairs K3 is timed at: what each
#: family's napkin plans for (``kernels/flash_attention.py`` ``_SK``,
#: ``kernels/ssd_scan.py`` ``PAIRS``); K3b over a training microbatch of
#: ``kernels/ssd_scan_bwd.py`` ``TOKENS`` tokens, rows of SQ.
FA_KEYS = 4096
FA_PAGE = 16
SSD_PAIRS = 24
#: Bytes that lie between two reads of one K1 weight copy: more than twice
#: the H100's 50 MB L2, so each launch reads B from device memory as the
#: serve path's projections do.
L2_FLUSH_BYTES = 128 * 2**20


def _build_inputs(family_name: str, data: Mapping[str, int], seed: int,
                  device: str, copies: int = 1
                  ) -> Tuple[List[Tuple[Any, ...]], Dict[str, Any], str]:
    """Deterministic operands for one family at one data shape, on
    ``device``: ``(arg tuples, keyword arguments, entry)``, where the arg
    tuples are ``copies`` sets to cycle through (K1 cycles copies of its
    weight B, the others share one set) and ``entry`` names the built
    callable's entry (``""``: the callable itself, ``"paged"``: its paged
    attribute).  What each key is timed at:

    - ``matmul_h100`` {M, N, K}: bf16 A [M, K] @ B [K, N] through the 2-D
      entry, the product the key names (the batched entry shares the key
      and is not timed);
    - ``matmul_experts_h100`` {E, M, N, K}: bf16 A [E, M, K] @ B [E, K, N],
      the forward's layout (the backward's reads of a transposed operand
      share the key);
    - ``flash_attention_h100`` {SQ, HD, GROUP, HK}: bf16, GROUP·HK query
      heads over HK KV heads of ``FA_KEYS`` keys (SQ if more); at SQ 1 the
      paged entry the decode step launches (one row, ``FA_PAGE``-token
      blocks, the row at its full length), else the dense entry, causal;
    - ``flash_attention_bwd_h100`` {SQ, HD, GROUP, HK}: bf16, one row of
      SQ queries of GROUP·HK heads over its own SQ keys, causal, as a
      training step's self-attention (o and dO drawn as q is);
    - ``ssd_scan_h100`` {SQ, HD, STATE}: one row of ``SSD_PAIRS`` heads,
      x, b, c bf16 with b and c shared across heads, the decay in (0, 1),
      the f32 state updated in place as the serve path does;
    - ``ssd_scan_bwd_h100`` {SQ, HD, STATE}: TOKENS / SQ rows (at least
      one) of ``SSD_PAIRS`` heads from a zero state, as a training step's scan:
      x, b, c and dy bf16, b and c shared across heads, the decay in (0,
      1), no final state's gradient;
    - ``matadd_h100`` / ``transpose_h100`` {M, N} f32; ``jacobi1d_h100``
      {N} f32, a call of 4 sweeps (one launch at F >= 4).
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    bf16 = torch.bfloat16
    if family_name == "matmul_h100":
        M, N, K = data["M"], data["N"], data["K"]
        a, b = normal((M, K), bf16), normal((K, N), bf16)
        return [(a, b)] + [(a, b.clone()) for _ in range(copies - 1)], {}, ""
    if family_name == "matmul_experts_h100":
        E, M, N, K = data["E"], data["M"], data["N"], data["K"]
        a, b = normal((E, M, K), bf16), normal((E, K, N), bf16)
        return [(a, b)] + [(a, b.clone()) for _ in range(copies - 1)], {}, ""
    if family_name == "flash_attention_h100":
        sq, hd = data["SQ"], data["HD"]
        hk = data["HK"]
        h = data["GROUP"] * hk
        if sq == 1:
            nblk = FA_KEYS // FA_PAGE
            q = normal((1, h, 1, hd), bf16)
            k = normal((nblk, FA_PAGE, hk, hd), bf16)
            v = normal((nblk, FA_PAGE, hk, hd), bf16)
            tables = torch.arange(nblk, dtype=torch.int32,
                                  device=device).view(1, nblk)
            lens = torch.full((1,), FA_KEYS, dtype=torch.int32, device=device)
            return [(q, k, v, tables, lens)], {"causal": True}, "paged"
        sk = max(FA_KEYS, sq)                 # K2 takes sq <= sk
        return [(normal((h, sq, hd), bf16), normal((hk, sk, hd), bf16),
                 normal((hk, sk, hd), bf16))], {"causal": True}, ""
    if family_name == "flash_attention_bwd_h100":
        sq, hd, hk = data["SQ"], data["HD"], data["HK"]
        h = data["GROUP"] * hk
        q, o, do = (normal((1, h, sq, hd), bf16) for _ in range(3))
        k, v = (normal((1, sq, hk, hd), bf16) for _ in range(2))
        lens = torch.full((1,), sq, dtype=torch.int32, device=device)
        return [(q, k, v, o, do, lens)], {"causal": True}, ""
    if family_name == "ssd_scan_h100":
        sq, hd, st = data["SQ"], data["HD"], data["STATE"]
        x = normal((1, sq, SSD_PAIRS, hd), bf16)
        a = torch.sigmoid(normal((1, sq, SSD_PAIRS)))      # decay in (0, 1)
        b, c = normal((1, sq, st), bf16), normal((1, sq, st), bf16)
        state = normal((1, SSD_PAIRS, st, hd))
        return [(x, a, b, c, state)], {"out_state": state}, ""
    if family_name == "ssd_scan_bwd_h100":
        sq, hd, st = data["SQ"], data["HD"], data["STATE"]
        from ..kernels.ssd_scan_bwd import TOKENS
        R = max(1, TOKENS // sq)
        x, dy = (normal((R, sq, SSD_PAIRS, hd), bf16) for _ in range(2))
        a = torch.sigmoid(normal((R, sq, SSD_PAIRS)))      # decay in (0, 1)
        b, c = normal((R, sq, st), bf16), normal((R, sq, st), bf16)
        return [(x, a, b, c, None, dy, None)], {}, ""
    if family_name == "matadd_h100":
        M, N = data["M"], data["N"]
        return [(normal((M, N)), normal((M, N)))], {}, ""
    if family_name == "transpose_h100":
        return [(normal((data["M"], data["N"])),)], {}, ""
    if family_name == "jacobi1d_h100":
        return [(normal((data["N"],)), 4)], {}, ""
    raise KeyError(f"no input builder for family {family_name!r}")


def _weight_copies(family_name: str, data: Mapping[str, int],
                   launches: int) -> int:
    """K1 and K1b cycle through enough copies of B (at most one a launch)
    that ``L2_FLUSH_BYTES`` lie between two reads of one copy."""
    if family_name not in ("matmul_h100", "matmul_experts_h100"):
        return 1
    nbytes = 2 * data.get("E", 1) * data["K"] * data["N"]
    return max(1, min(launches, math.ceil(L2_FLUSH_BYTES / nbytes)))


class DeviceTimer:
    """The ``Timer`` contract on ``cfg.device``, with the operands of the
    last (family, shape) kept between calls (a bucket's candidates share
    them; :meth:`clear` frees them).

    On ``"cuda"`` it times device time, not launch cost: ``launches``
    launches of the candidate (K1 over its weight copies) are captured in
    one CUDA graph, and each repeat is one replay between two CUDA events,
    divided by ``launches`` — every serve step is a graph replay, and an
    eager launch whose host cost exceeds its device time would read the
    host cost.  The candidate is run once eagerly before its capture (a new
    callable's first launch loads the kernel library and opts into its
    shared memory), even at ``warmup=0``; ``cfg.warmup`` untimed replays
    follow.  The graph is a serve step's ``CapturedStep``
    (``runtime/graph.py``), so the launch counters count the launches that
    ran, not the capture's.  The launches run on the split workspaces of
    :func:`repro_torch.kernels.workspace.scratch`, so a timer may run while
    a serving engine's graphs hold the engine's.  A failed launch raises
    (``measure_table`` records ``us=None``, unless it is an error of the
    CUDA runtime, which propagates).  On ``"cpu"`` each repeat is one call
    of the plain version under ``time.perf_counter``.
    """

    def __init__(self, launches: int = 10):
        if launches < 1:
            raise ValueError(f"launches must be >= 1: {launches}")
        self.launches = int(launches)
        self._key: Optional[Tuple[Any, ...]] = None
        self._inputs: Optional[Tuple[List[Tuple[Any, ...]], Dict[str, Any],
                                     str]] = None

    def clear(self) -> None:
        """Drop the kept operands."""
        self._key = self._inputs = None

    def _operands(self, family: FamilySpec, data: Mapping[str, int],
                  cfg: "MeasureConfig"):
        key = (family.name, tuple(sorted(data.items())), cfg.seed,
               cfg.device)
        if key != self._key:
            self._inputs = None               # free before the next draw
            seed = _seed_for(family.name, repr(sorted(data.items())),
                             cfg.seed)
            copies = (_weight_copies(family.name, data, self.launches)
                      if cfg.device != "cpu" else 1)
            self._inputs = _build_inputs(family.name, data, seed,
                                         cfg.device, copies)
            self._key = key
        return self._inputs

    def __call__(self, family: FamilySpec, plan: KernelPlan,
                 assignment: Mapping[str, int], data: Mapping[str, int],
                 cfg: "MeasureConfig") -> List[float]:
        fn = family.instantiate(plan, dict(assignment), cfg.device)
        sets, kwargs, entry = self._operands(family, data, cfg)
        call = getattr(fn, entry) if entry else fn
        if cfg.device == "cpu":
            return self._host_times(call, sets[0], kwargs, cfg)
        from ..kernels.workspace import scratch
        with scratch():
            return self._device_times(call, sets, kwargs, cfg)

    def _host_times(self, call, args, kwargs, cfg) -> List[float]:
        for _ in range(max(1, cfg.warmup)):
            call(*args, **kwargs)
        out = []
        for _ in range(max(1, cfg.iters)):
            t0 = time.perf_counter()
            call(*args, **kwargs)
            out.append(time.perf_counter() - t0)
        return out

    def _device_times(self, call, sets, kwargs, cfg) -> List[float]:
        from ..kernels.jacobi1d import jacobi1d_h100
        from ..kernels.matadd import matadd_h100
        from ..kernels.transpose import transpose_h100
        from ..runtime.graph import COUNTED, CapturedStep, CudaGraph

        def launches() -> None:
            for i in range(self.launches):
                call(*sets[i % len(sets)], **kwargs)

        call(*sets[0], **kwargs)              # library load, smem opt-in
        step = CapturedStep(launches, CudaGraph(None), counted=COUNTED + (
            transpose_h100, matadd_h100, jacobi1d_h100))
        main = torch.cuda.current_stream(torch.device(cfg.device))
        out = []
        for rep in range(max(0, cfg.warmup) + max(1, cfg.iters)):
            # nothing but the replay between the two events: host work
            # there would be timed whenever the card waits for the host
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(main)
            step.graph.replay()
            end.record(main)
            step.count()
            end.synchronize()
            if rep >= cfg.warmup:
                out.append(start.elapsed_time(end) * 1e-3 / self.launches)
        return out


def default_timer(family: FamilySpec, plan: KernelPlan,
                  assignment: Mapping[str, int], data: Mapping[str, int],
                  cfg: MeasureConfig) -> List[float]:
    """Run the candidate kernel; return per-repeat times in seconds (a
    :class:`DeviceTimer` of its own, so nothing is kept between calls).

    Raises on instantiation/execution failure — ``measure_table`` converts
    that into a ``us=None`` sample.
    """
    return DeviceTimer()(family, plan, assignment, data, cfg)


def trimmed_mean_us(repeats: Sequence[float], trim: int) -> float:
    """Trimmed mean (seconds -> microseconds); robust to scheduler noise."""
    xs = sorted(float(r) for r in repeats)
    if trim > 0 and len(xs) > 2 * trim:
        xs = xs[trim:-trim]
    return float(np.mean(xs) * 1e6)


Timer = Callable[[FamilySpec, KernelPlan, Mapping[str, int],
                  Mapping[str, int], MeasureConfig], List[float]]


def measure_table(family: FamilySpec, table: Mapping[str, Any],
                  cfg: MeasureConfig = MeasureConfig(),
                  timer: Optional[Timer] = None,
                  progress: Optional[Callable[[str], None]] = None
                  ) -> List[MeasuredSample]:
    """Time the top-``cfg.top_k`` candidates of every bucket in ``table``.

    ``timer`` is injectable (tests use a deterministic fake; a tuning run
    passes one :class:`DeviceTimer` so a bucket's operands are drawn once);
    the default is :func:`default_timer`.
    """
    from ..artifacts import serde
    timer = timer or default_timer
    samples: List[MeasuredSample] = []
    leaves = serde.table_leaves(table)
    for bucket in sorted(table.get("buckets", {})):
        entries = table["buckets"][bucket]
        measured_entries = entries[:cfg.top_k]
        try:
            data = measure_shape(
                family.name, parse_bucket_key(bucket),
                [{k: int(v) for k, v in e["assignment"].items()}
                 for e in measured_entries], cfg.max_dim)
        except (KeyError, TypeError, ValueError):
            continue                          # unparseable bucket: skip
        for pos, entry in enumerate(measured_entries):
            leaf = leaves.get(int(entry["leaf_index"]))
            if leaf is None:
                continue
            asg = {k: int(v) for k, v in entry["assignment"].items()}
            if progress:
                progress(f"{family.name}/{bucket}#{pos} {asg}")
            try:
                repeats = timer(family, leaf.plan, asg, data, cfg)
                us: Optional[float] = trimmed_mean_us(repeats, cfg.trim)
            except Exception as e:            # noqa: BLE001 — failure is data
                if device_error(e):
                    raise                     # the context may be lost
                repeats, us = [], None
            samples.append(MeasuredSample(
                bucket=bucket, entry_index=pos,
                leaf_index=int(entry["leaf_index"]), assignment=asg,
                score=float(entry["score"]), data=dict(data), us=us,
                repeats=[float(r) for r in repeats]))
    return samples
