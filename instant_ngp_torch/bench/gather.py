"""Gather microbenchmarks on the card: the port of
``scripts/bench_gather_tpu.py`` (row gather ``take(table, idx)``, N = 2^20
rows) and ``scripts/bench_dyngather.py`` (column gather
``take_along_axis(x, (idx + k) % T)`` summed over 8 reps on (T, 128)),
with the same case lists.

    python -m instant_ngp_torch.bench.gather [--iters 50] [--warmup 5]

Lines, as in the TPU scripts:
  A   ``torch.index_select``, the library call, at every (T, F, dtype) of
      bench_gather_tpu.py:64-66
  B   kernel I (``ops.gather.take_rows``) at :102-108
  B2  kernel I at :111-115 (the TPU script's scalar-loop lowering of the
      same gather; on the card it is the same kernel)
  D   a plain torch one-hot matmul (bf16, chunked to bound memory) at
      :125-129
  J   kernel J (``ops.gather.gather_cols_sum``) at bench_dyngather.py:68-70
Each line prints the time per call and per row (per element for J), and
the same for the plain version (``take_rows_plain``,
``gather_cols_sum_plain``). Times are CUDA events around ``iters``
back-to-back calls after ``warmup`` calls, divided by ``iters``. Every
kernel result is first checked to equal its plain version. There is no CPU
path: without a card it raises.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.gather import gather_cols_sum, gather_cols_sum_plain, take_rows, take_rows_plain

N = 1 << 20  # rows per row gather (queries)
F32, BF16 = torch.float32, torch.bfloat16
# (log2 T, F, dtype), bench_gather_tpu.py:64-66, :102-103 and :111-112
TAKE_LIBRARY_CASES = [(19, 4, F32), (19, 4, BF16), (19, 16, BF16), (15, 4, F32), (19, 32, BF16)]
TAKE_KERNEL_CASES = [(19, 4, F32), (19, 4, BF16), (15, 4, F32)]
TAKE_LOOP_CASE = (19, 4, F32)
ONEHOT_LOG2_T = (12, 14)  # F = 4 f32 tables, bench_gather_tpu.py:125-127
ONEHOT_CHUNK = 1 << 16  # rows per one-hot product: (2^16, 2^14) bf16 is 2 GiB
# (T, dtype) of bench_dyngather.py:68-70, L = 128, 8 reps
COLS, REPS = 128, 8
COL_CASES = [(8, F32), (64, F32), (512, F32), (4096, F32), (32768, F32), (4096, BF16)]


def time_ms(fn, iters: int, warmup: int) -> float:
    """Milliseconds per call: CUDA events around iters calls after warmup."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def onehot_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take(table, idx) as one-hot (N, T) @ table in bf16, in chunks of
    ONEHOT_CHUNK rows. One product per output, so the bf16 result is the
    bf16 row exactly."""
    cols = torch.arange(table.shape[0], device=table.device)
    tb = table.to(BF16)
    return torch.cat([((idx[i:i + ONEHOT_CHUNK, None] == cols).to(BF16) @ tb).float()
                      for i in range(0, idx.shape[0], ONEHOT_CHUNK)])


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _row_line(name: str, fn, plain, table, idx, iters: int, warmup: int) -> dict:
    ms = time_ms(lambda: fn(table, idx), iters, warmup)
    plain_ms = time_ms(lambda: plain(table, idx), iters, warmup)
    n = idx.shape[0]
    line = {"case": name, "ms": ms, "ns_per_row": ms * 1e6 / n,
            "plain_ms": plain_ms, "plain_ns_per_row": plain_ms * 1e6 / n}
    print(f"{name:48s} {ms:9.4f} ms {line['ns_per_row']:8.4f} ns/row   plain {plain_ms:9.4f} ms "
          f"{line['plain_ns_per_row']:8.4f} ns/row", flush=True)
    return line


def _row_inputs(gen, log2_t: int, f: int, dtype):
    t = 1 << log2_t
    table = torch.randn((t, f), generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, t, (N,), generator=gen, device="cuda", dtype=torch.int32)
    return table, idx


def run(iters: int = 50, warmup: int = 5, seed: int = 0) -> list[dict]:
    """Every case of both TPU scripts on the card; returns the printed lines."""
    if not torch.cuda.is_available():
        raise RuntimeError("the gather microbenchmarks need a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lines = []
    for log2_t, f, dtype in TAKE_LIBRARY_CASES:
        table, idx = _row_inputs(gen, log2_t, f, dtype)
        lines.append(_row_line(f"A index_select T=2^{log2_t} F={f} {_dtype_name(dtype)}",
                               lambda t, i: torch.index_select(t, 0, i), take_rows_plain,
                               table, idx, iters, warmup))
    kernel_cases = [("B kernel I", c) for c in TAKE_KERNEL_CASES] + [("B2 kernel I", TAKE_LOOP_CASE)]
    for label, (log2_t, f, dtype) in kernel_cases:
        table, idx = _row_inputs(gen, log2_t, f, dtype)
        if not torch.equal(take_rows(table, idx), take_rows_plain(table, idx)):
            raise RuntimeError(f"kernel I differs from its plain version at T=2^{log2_t} F={f}")
        lines.append(_row_line(f"{label} T=2^{log2_t} F={f} {_dtype_name(dtype)}", take_rows,
                               take_rows_plain, table, idx, iters, warmup))
    for log2_t in ONEHOT_LOG2_T:
        table, idx = _row_inputs(gen, log2_t, 4, F32)
        lines.append(_row_line(f"D one-hot matmul T=2^{log2_t} F=4", onehot_take,
                               take_rows_plain, table, idx, max(1, iters // 10), 1))
    for t, dtype in COL_CASES:
        x = torch.randn((t, COLS), generator=gen, device="cuda").to(dtype)
        idx = torch.randint(0, t, (t, COLS), generator=gen, device="cuda", dtype=torch.int32)
        if not torch.equal(gather_cols_sum(x, idx, REPS), gather_cols_sum_plain(x, idx, REPS)):
            raise RuntimeError(f"kernel J differs from its plain version at T={t} {dtype}")
        ms = time_ms(lambda: gather_cols_sum(x, idx, REPS), iters, warmup)
        plain_ms = time_ms(lambda: gather_cols_sum_plain(x, idx, REPS), iters, warmup)
        n = t * COLS * REPS  # elements gathered per call
        line = {"case": f"J kernel J T={t} L={COLS} reps={REPS} {_dtype_name(dtype)}",
                "ms": ms, "us_per_gather": ms * 1e3 / REPS, "ns_per_elem": ms * 1e6 / n,
                "plain_ms": plain_ms, "plain_us_per_gather": plain_ms * 1e3 / REPS,
                "plain_ns_per_elem": plain_ms * 1e6 / n}
        print(f"{line['case']:48s} {line['us_per_gather']:9.2f} us/gather "
              f"{line['ns_per_elem']:8.4f} ns/elem ({n / ms / 1e6:7.2f} G elem/s)   plain "
              f"{line['plain_us_per_gather']:9.2f} us/gather {line['plain_ns_per_elem']:8.4f} "
              f"ns/elem", flush=True)
        lines.append(line)
    return lines


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--warmup", type=int, default=5)
    args = parser.parse_args()
    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    lines = run(args.iters, args.warmup)
    print(f"{len(lines)} lines on {name}")


if __name__ == "__main__":
    main()
