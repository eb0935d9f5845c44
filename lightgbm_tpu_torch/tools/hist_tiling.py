"""Time the port's histogram kernels over row-chunk counts on one card.

    python3 -m lightgbm_tpu_torch.tools.hist_tiling   (repository root)

For each slot width of the rounds grower's ladder (1 = the root
hist_nat, 8, 32, 48) it times hist_round and hist_nat at the main
path's shapes (1,001,472 rows, 28 columns, 256 bins, random valid split
params) with the row axis cut into a given number of chunks per tile,
and prints one JSON line per (width, chunks) with the median
milliseconds over CUDA events. `chunks: null` is the tiling that
learner/cuda_hist._hist_tiling picks. Needs a CUDA device.
"""

import json
import statistics
import sys

N_ROWS, G, BC, L = 1_001_472, 28, 256, 255


def cuda_ms(torch, fn, reps: int = 10, warm: int = 3) -> float:
    """Median milliseconds of fn() over CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch sees no CUDA device\n")
        return 2
    from ..learner import cuda_hist as ch
    from ..learner import histogram as h

    dev = torch.device("cuda")
    N = N_ROWS
    gen = torch.Generator().manual_seed(1)
    bins = torch.randint(0, BC - 1, (G, N), generator=gen,
                         dtype=torch.int32).to(dev)
    gh = torch.stack([torch.randint(-128, 129, (N,), generator=gen),
                      torch.randint(0, 257, (N,), generator=gen),
                      torch.ones(N, dtype=torch.int64)]).to(torch.int32)
    gh = gh.to(dev)
    pleaf = torch.randint(0, L + 1, (N,), generator=gen,
                          dtype=torch.int32).to(dev)
    default_tiling = ch._hist_tiling

    def tiling(chunks):
        def f(G_, N_, S_, Bc_, extra, device):
            Sc, Gc, rows = default_tiling(G_, N_, S_, Bc_, extra, device)
            return Sc, Gc, (rows if chunks is None else -(-N_ // chunks))
        return f

    smi = torch.cuda.get_device_name(0)
    try:
        for S in (1, 8, 32, 48):
            params = torch.zeros((S, 16), dtype=torch.int32)
            params[:, 0] = torch.randperm(L, generator=gen)[:S].to(torch.int32)
            params[:, 1] = torch.randint(0, G, (S,), generator=gen)
            params[:, 2] = torch.randint(0, BC - 6, (S,), generator=gen)
            params[:, 5] = torch.randint(0, 2, (S,), generator=gen)
            params[:, 6] = 300 + torch.arange(S)
            params[:, 8] = -1
            params = params.to(dev)
            slot = (torch.zeros(N, dtype=torch.int32, device=dev) if S == 1
                    else torch.randint(0, S + 1, (N,), generator=gen,
                                       dtype=torch.int32).to(dev))
            for chunks in (None, 2, 4, 8, 16, 32, 64, 128, 489):
                ch._hist_tiling = tiling(chunks)
                t_round = cuda_ms(torch, lambda: h.hist_round(
                    bins, gh, pleaf, params, S, BC, L))
                t_nat = cuda_ms(torch, lambda: h.hist_nat_slots(
                    bins, gh, slot, S, BC))
                print(json.dumps({"device": smi, "slots": S,
                                  "chunks": chunks,
                                  "hist_round_ms": t_round,
                                  "hist_nat_ms": t_nat}), flush=True)
    finally:
        ch._hist_tiling = default_tiling
    return 0


if __name__ == "__main__":
    sys.exit(main())
