"""Time the port's histogram kernels over row-chunk counts on one card.

    python3 -m lightgbm_tpu_torch.tools.hist_tiling   (repository root)

For each slot width of the rounds grower's ladder (1 = the root
hist_nat, 8, 32, 48) it times hist_round and hist_nat at the main
path's shapes (1,001,472 rows, 28 columns, 256 bins, random valid split
params), on int32 (int16 mode) and int8 levels (int8 mode), with the
row axis cut into a given number of chunks per tile, and prints one
JSON line per (width, chunks) with the median milliseconds over CUDA
events. Then hist_nat's f32 mode at the percentile refit's shape (one
column, 255 or 31 leaf slots + trash, 256 bins), once with every row
in a slot (a first refit pass) and once with 1 row in 64 (a later
pass). Per slot width it also times the int8 modes against the int32
channels of the same 4-level values (`same_4_levels`: int8, int32,
int32, int8), which isolates the channel width from the values.
`chunks: null` is the tiling that learner/cuda_hist._hist_tiling picks.
Needs a CUDA device.
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
    gh8 = torch.stack([torch.randint(-2, 3, (N,), generator=gen),
                       torch.randint(0, 5, (N,), generator=gen),
                       torch.ones(N, dtype=torch.int64)]).to(torch.int8)
    gh8 = gh8.to(dev)
    pleaf = torch.randint(0, L + 1, (N,), generator=gen,
                          dtype=torch.int32).to(dev)
    default_tiling = ch._hist_tiling

    def tiling(chunks):
        def f(G_, N_, S_, Bc_, extra, device, cell_words=1):
            Sc, Gc, rows = default_tiling(G_, N_, S_, Bc_, extra, device,
                                          cell_words)
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
                t_round8 = cuda_ms(torch, lambda: h.hist_round(
                    bins, gh8, pleaf, params, S, BC, L, levels=4))
                t_nat8 = cuda_ms(torch, lambda: h.hist_nat_slots(
                    bins, gh8, slot, S, BC, levels=4))
                print(json.dumps({"device": smi, "slots": S,
                                  "chunks": chunks,
                                  "hist_round_ms": t_round,
                                  "hist_nat_ms": t_nat,
                                  "hist_round_int8_ms": t_round8,
                                  "hist_nat_int8_ms": t_nat8}), flush=True)
            # the channel width alone: the same 4-level values as int8
            # and as int32 channels, timed int8, int32, int32, int8
            ch._hist_tiling = default_tiling
            gh8w = gh8.to(torch.int32)
            same = {"int8": [], "int32": []}
            for name in ("int8", "int32", "int32", "int8"):
                g_ = gh8 if name == "int8" else gh8w
                same[name].append((
                    cuda_ms(torch, lambda: h.hist_round(
                        bins, g_, pleaf, params, S, BC, L, levels=4)),
                    cuda_ms(torch, lambda: h.hist_nat_slots(
                        bins, g_, slot, S, BC, levels=4))))
            print(json.dumps({
                "device": smi, "slots": S, "chunks": None,
                "same_4_levels": {
                    f"hist_{k}_{w}_ms": [t[i] for t in same[w]]
                    for i, k in enumerate(("round", "nat"))
                    for w in ("int8", "int32")}}), flush=True)
        # hist_nat's f32 mode at the percentile refit's shape
        rbins = torch.randint(0, BC, (1, N), generator=gen,
                              dtype=torch.int32).to(dev)
        w = torch.rand(N, generator=gen).to(dev)
        for S, share in ((L, 1), (L, 64), (31, 1), (31, 64)):
            inb = (torch.arange(N, device=dev) % share) == 0
            rgh = torch.stack([torch.where(inb, w, 0.0), torch.zeros_like(w),
                               inb.to(torch.float32)])
            rslot = torch.where(
                inb, torch.randint(0, S, (N,), generator=gen,
                                   dtype=torch.int32).to(dev), S)
            t = cuda_ms(torch, lambda: ch.hist_nat_f32(
                rbins, rgh, rslot, S, BC))
            print(json.dumps({"device": smi, "refit_rows_share":
                              f"1/{share}", "slots": S,
                              "hist_nat_f32_ms": t}), flush=True)
    finally:
        ch._hist_tiling = default_tiling
    return 0


if __name__ == "__main__":
    sys.exit(main())
