"""The JAX package's seven examples (``examples/*.py``) on the port.

Each is a module with ``main(argv=None)``, run as ``python -m
deeplearning4j_tpu_torch.examples.<name>``: the reference example's
flags, sizes and printed lines, in its order, plus ``--device`` (default
``cuda``; the CPU only with ``--device cpu``; without a card the example
stops with ``resolve_device``'s message, never falling back).  Before it
exits, each prints one line of its own, ``kernel launches: {...}``, the
hand kernels B1-B5 that its run launched (the counters that
``chip_smoke.py``'s ``kernels`` line reads).

The examples that need several devices (``data_parallel``,
``parallelism_axes``) take ``--ranks N``: a device of the reference is a
rank here, and :func:`run_ranks` spawns the ranks, joined through a
``file://`` rendezvous in a temporary directory.  On the CPU they use
gloo; on the card gloo too where there are more ranks than cards (NCCL
refuses two ranks on one card), else NCCL with one rank a card.  A rank
that dies, fails or outlives the deadline fails the example with a
message naming it.

This module holds what the examples share: the parser's ``--device``,
the launch counters, and the rank spawner.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, NamedTuple, Sequence

import torch

from deeplearning4j_tpu_torch import resolve_device

#: the prefix of the launches line every example prints before it exits
LAUNCHES_PREFIX = "kernel launches:"

#: the launch counters' names, as ``chip_smoke.py``'s ``kernels`` line
#: names the kernels (B1, B2, B3, B4, B5)
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "word2vec_chunk", "glove_chunk")

#: seconds the ranks of a spawned example have to finish
RANK_DEADLINE_S = 120.0


def parser(doc: str) -> argparse.ArgumentParser:
    """The example's parser, with ``--device``."""
    p = argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs "
                        "the CPU path, the kernels' plain twins)")
    return p


def device(args) -> torch.device:
    """``args.device`` resolved; without the card asked for, the example
    stops with ``resolve_device``'s message."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def reset_launches() -> None:
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_glove as fg
    from deeplearning4j_tpu_torch.ops import fused_word2vec as fw

    for mod in (fa, fw, fg):
        mod.reset_launches()


def launch_counts() -> Dict[str, int]:
    """This process's B1-B5 launches since :func:`reset_launches`."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_glove as fg
    from deeplearning4j_tpu_torch.ops import fused_word2vec as fw

    flash = fa.launch_counts()
    return dict(zip(KERNELS, (flash["launches"], flash["launches_dkv"],
                              flash["launches_dq"], fw.launches,
                              fg.launches)))


def add_counts(counts: Sequence[Dict[str, int]]) -> Dict[str, int]:
    return {k: sum(c[k] for c in counts) for k in KERNELS}


def print_launches(counts: Dict[str, int]) -> None:
    print(LAUNCHES_PREFIX, json.dumps(counts), flush=True)


class Rank(NamedTuple):
    """What a spawned rank knows of its run."""
    rank: int
    world: int
    device: str


def backend_for(world: int, dev: torch.device) -> str:
    """gloo on the CPU and for more ranks than cards; NCCL with one rank
    a card."""
    if dev.type != "cuda" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def _rank_entry(target: Callable, rank: Rank, backend: str, rdv: str,
                out: str, args: tuple, timeout: float) -> None:
    """One spawned rank: join the group, run ``target(rank, *args)``,
    write ``("ok", result)`` or ``("error", traceback)`` to ``out``.  A
    rank that failed exits with code 1 at once, so its peers, blocked in
    a collective, are not waited for."""
    import sys

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh as pm

    if rank.device == "cpu":
        torch.set_num_threads(1)
    try:
        pm.initialize_distributed(f"file://{rdv}", rank.world, rank.rank,
                                  device=rank.device, backend=backend,
                                  timeout=timeout)
        result = ("ok", target(rank, *args))
    except Exception:  # noqa: BLE001 — the parent reports it
        result = ("error", traceback.format_exc())
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, out)
    if result[0] != "ok":
        sys.stdout.flush()
        os._exit(1)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(name: str, target: Callable, world: int, dev: torch.device,
              args: tuple = (), deadline: float = RANK_DEADLINE_S) -> list:
    """``target(Rank, *args)`` on each of ``world`` spawned ranks of one
    process group (the backend from :func:`backend_for`); their results
    by rank.  The ranks have ``deadline`` seconds: one that dies, fails
    or is still running then ends the run, the others killed, with a
    ``SystemExit`` that names it (the pattern of
    ``chip_smoke.ma_start``/``ma_join``)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    backend = backend_for(world, dev)
    tmp = tempfile.mkdtemp(prefix=f"dl4j_example_{name}_")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(
        target=_rank_entry,
        args=(target, Rank(r, world, str(dev)), backend,
              os.path.join(tmp, "rdv"), outs[r], args, deadline))
        for r in range(world)]
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.start()
        failed = []
        while time.monotonic() < end:
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or all(p.exitcode == 0 for p in procs):
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if failed:
            raise SystemExit(f"{name}: " + "\n".join(
                _failure(r, procs[r].exitcode, outs[r]) for r in failed)
                + (f"\nranks {hung} killed" if hung else ""))
        if hung:
            raise SystemExit(f"{name}: ranks {hung} still running after "
                             f"{deadline:g} s: killed")
        results = []
        for r, out in enumerate(outs):
            if not os.path.exists(out):
                raise SystemExit(f"{name}: rank {r} exited with no result")
            with open(out, "rb") as f:
                results.append(pickle.load(f)[1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return results


def _failure(rank: int, exitcode: int, out: str) -> str:
    """A failed rank's report: its traceback where it wrote one."""
    if os.path.exists(out):
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            return f"rank {rank} failed:\n{value}"
    return f"rank {rank} died (exit code {exitcode})"


def default_ranks(dev: torch.device) -> int:
    """One rank a card; one rank on the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1

