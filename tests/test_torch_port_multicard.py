"""``chip_smoke.py --cards 4`` (phase 18, the parallel axes across four
cards on NCCL) rehearsed on the CPU, and its refusals.

One spawn of four gloo processes runs phase 18's rank function
(``chip_smoke.multicard_rank``) for its legs (a) data 4 and (b) data 2 x
spatial 2 at the tiny flagship (128x64, ndf 8), ``device="cpu"``: each leg
takes one step of the phase-2 recipe in the kernel configuration, one image
a spatial group, and rank 0 holds it against one process's step on the
global batch by phase 7 (a)'s rule (fp32 with two perturbed-input controls,
a tensor over the bound decided by both steps in float64 within 1e-9), the
ranks' uniforms, gathered, bit-equal to one process's draws; every rank
checks the all-reduced gradients and metrics, and the parameters after
``step.apply``, bit-identical to rank 0's. A rank whose hold fails raises,
and its exit code fails the tests here. On the CPU the kernels' plain
versions run, so no launch is counted.

The mode itself refuses to run with fewer than four CUDA devices, and
never drops to gloo or to fewer ranks.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import chip_smoke
from jpdse_tpu_torch.parallel import distributed
from test_torch_port_threads import port_test_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SEED = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int, work: str) -> None:
    torch.set_num_threads(1)
    chip_smoke.multicard_rank(rank, port, SEED, work, "cpu", "gloo", tiny=True, legs="ab")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results of legs (a) and (b), and their exit codes."""
    work = tmp_path_factory.mktemp("cards")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(work))) for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = [torch.load(work / f"rank{r}.pt", weights_only=False) if code == 0 else None
               for r, code in enumerate(codes)]
    return {"codes": codes, "results": results}


def test_every_rank_held_its_steps_and_exited(ranks):
    assert ranks["codes"] == [0, 0, 0, 0], "a rank's hold or collective failed"
    for r, res in enumerate(ranks["results"]):
        assert (res["backend"], res["device"]) == ("gloo", "cpu"), r


@pytest.mark.parametrize("leg,spatial_calls", [("a", False), ("b", True)])
def test_each_layout_steps_as_one_process(ranks, leg, spatial_calls):
    """Both layouts' steps were held on rank 0; the all-reduce carried the
    same gradient bytes everywhere; only data 2 x spatial 2 exchanges rows,
    each rank making the same number of all-reduces; the CPU counts no
    kernel launch."""
    assert ranks["codes"] == [0, 0, 0, 0]
    got = [res[leg] for res in ranks["results"]]
    assert len({g["grad_mib"] for g in got}) == 1 and got[0]["grad_mib"] > 0
    calls = [g["traffic"]["calls"] for g in got]
    assert len(set(calls)) == 1 and (calls[0] > 0) == spatial_calls, calls
    for g in got:
        assert not any(g["counts"][n] for n in chip_smoke.CARDS_K3), g["counts"]


def test_cards_flag_exits_with_its_reason_without_four_cards():
    """``chip_smoke.py --cards 4`` with fewer than four CUDA devices (none
    here) exits non-zero, says why, and prints no result line."""
    if torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA devices are present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py", "--cards", "4"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "needs 4 CUDA devices" in out.stderr and '"ok"' not in out.stdout


def test_phase18_refuses_fewer_cards_before_starting_a_rank(monkeypatch):
    """Two visible cards: phase 18 raises before it builds or spawns
    anything; it does not run four ranks on two cards or fewer ranks."""
    started = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.multiprocessing, "get_context",
                        lambda *a: started.append(a) or pytest.fail("a rank was spawned"))
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        chip_smoke.phase18(0)
    assert not started


def test_a_failed_nccl_group_raises_and_is_not_replaced_by_gloo(monkeypatch):
    """A rank on its card asks for NCCL; where NCCL fails to start (here a
    stand-in ``init_process_group`` that refuses), ``initialize`` raises
    naming it after that one attempt: no gloo group, no second try, and
    no group is left behind."""
    calls = []

    def refuse(backend, **kwargs):
        calls.append((backend, kwargs.get("device_id"), kwargs["world_size"], kwargs["rank"]))
        raise RuntimeError("NCCL error: unhandled system error")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="initializing the nccl process group failed "
                                           r"\(process 2 of 4"):
        distributed.initialize("cuda", "localhost:1", 4, 2)
    assert calls == [("set_device", 2), ("nccl", torch.device("cuda", 2), 4, 2)]
    assert not dist.is_initialized()
