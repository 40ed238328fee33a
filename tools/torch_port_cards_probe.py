#!/usr/bin/env python3
"""A short check of a machine of four cards before ``chip_smoke.py --cards
4``: one process a card joins an NCCL group through the port's
``parallel.distributed.initialize``, builds both of phase 18's layouts'
subgroups (``parallel.mesh.mesh_from_config`` at spatial_axis 2 and 4),
all-reduces once on each (a float and an int32 tensor over the spatial
group, a row gather over the data group), runs K1, K2, K3, K3's partial
stats and K4 (bf16, its TMA tensor maps) on its card against their plain
versions, and times an all-reduce of the phase-2 step's 783.9 MiB of
gradients as one flat buffer.

    python3 tools/torch_port_cards_probe.py [--out chiprun_out]

Prints the cards (``nvidia-smi``), ``nvidia-smi topo -m`` (or why it
prints nothing), NCCL's version, each rank's exit code, and each rank's
results as a JSON line (also written to OUT/cards_probe_rank{r}.json).
Exits non-zero unless four CUDA devices are visible and every rank's
checks pass.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CARDS = 4
GRAD_BYTES = 783.9 * 2**20  # the phase-2 step's fp32 gradients (chip_smoke.py phase 12)


def rank_main(rank: int, port: int, out: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    import torch.distributed as dist

    from jpdse_tpu_torch.ops import head_conv as k4, instance_norm as k3, realign
    from jpdse_tpu_torch.ops.build import build_all
    from jpdse_tpu_torch.parallel import distributed, mesh as mesh_mod

    res = {"rank": rank}
    t0 = time.perf_counter()
    build_all()
    res["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    distributed.initialize("cuda", f"localhost:{port}", CARDS, rank)
    res["init_s"] = time.perf_counter() - t0
    res["backend"], res["device"] = dist.get_backend(), torch.cuda.current_device()
    dev = torch.device("cuda", rank)
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    checks = {"world sum": x.tolist() == [10.0] * 4}
    for s in (2, CARDS):
        t0 = time.perf_counter()
        m = mesh_mod.mesh_from_config(SimpleNamespace(data_axis=-1, spatial_axis=s))
        res[f"groups at spatial {s} s"] = time.perf_counter() - t0
        shard = m.shard(64)
        y = shard.all_reduce_(torch.full((3,), float(rank + 1), device=dev))
        z = shard.all_reduce_(torch.tensor([rank], device=dev, dtype=torch.int32))
        rows = m.gather_rows(torch.full((1, 2), float(rank), device=dev))
        group = range(m.data_index * s, (m.data_index + 1) * s)
        checks[f"spatial {s} sum"] = y.tolist() == [float(sum(r + 1 for r in group))] * 3
        checks[f"spatial {s} int sum"] = z.tolist() == [sum(group)]
        checks[f"spatial {s} data gather"] = rows[:, 0].tolist() == [
            float(d * s + m.spatial_index) for d in range(m.n_data)]
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = torch.randn((1, 64, 128, 64), device=dev, generator=gen)
    res["K3 err"] = float((k3.fused_instance_norm(xs, None, True)
                           - k3.fused_instance_norm_plain(xs, None, True)).abs().max())
    st, want = k3.instance_norm_stats(xs), k3.instance_norm_stats_plain(xs)
    res["K3 stats err"] = float(((st - want).abs() / want.abs().clamp_min(1.0)).max())
    xf = torch.randn((1, 64, 128, 3), device=dev, generator=gen)
    checks["K2 bit-equal"] = bool(torch.equal(realign.s2d_pad3(xf), realign.s2d_pad3_plain(xf)))
    y = torch.randn((1, 32, 64, 64), device=dev, generator=gen).to(torch.bfloat16)
    checks["K1 bit-equal"] = bool(torch.equal(realign.s2d_realign_pad3(y),
                                              realign.s2d_realign_pad3_plain(y)))
    checks["K3 within 1e-5"] = res["K3 err"] <= 1e-5 and res["K3 stats err"] <= 1e-5
    kp, c, n, ho, wo = 4, k4.padded_channels(156), 256, 64, 128
    rows = ho + kp - 1 + k4.head_conv_extra_rows(ho, kp)
    xp = torch.randn((1, rows, wo + 3, c), device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn((kp, kp * c, n), device=dev, generator=gen) * 0.02).to(torch.bfloat16)
    want = k4.head_conv_s2d_plain(xp, w, kp, ho=ho).float()
    res["K4 rel err"] = float((k4.head_conv_s2d(xp, w, kp, ho=ho).float() - want).abs().max()
                              / want.abs().max())
    checks["K4 within 1e-2"] = res["K4 rel err"] <= 1e-2  # bf16, chip_smoke.py phase 3's bound
    flat = torch.ones(int(GRAD_BYTES / 4), device=dev)
    for _ in range(2):
        dist.all_reduce(flat)
    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    res["783.9 MiB all-reduce ms"] = times
    res["bus GB/s"] = 2 * (CARDS - 1) / CARDS * GRAD_BYTES / (min(times) * 1e-3) / 1e9
    res["checks"] = checks
    distributed.barrier()
    dist.destroy_process_group()
    Path(out, f"cards_probe_rank{rank}.json").write_text(json.dumps(res))
    if not all(checks.values()):
        raise SystemExit(f"rank {rank}: {checks}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if torch.cuda.device_count() < CARDS:
        print(f"needs {CARDS} CUDA devices; torch.cuda.device_count() is "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    for cmd in (["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                ["nvidia-smi", "topo", "-m"]):
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        print(f"$ {' '.join(cmd)}\n{(run.stdout + run.stderr).strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, port, args.out)) for r in range(CARDS)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + 240
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.perf_counter()))
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    print(f"exit codes {codes}")
    for r in range(CARDS):
        path = Path(args.out, f"cards_probe_rank{r}.json")
        print(path.read_text() if path.exists() else f"rank {r}: no result")
    return 0 if codes == [0] * CARDS else 1


if __name__ == "__main__":
    sys.exit(main())
