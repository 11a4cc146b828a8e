"""Command-line interface: train / test / predict / telemetry.

Port of ``deeplearning4j_tpu/cli.py`` (``deeplearning4j-cli``'s args4j
subcommands ``cli/subcommands/{Train,Test,Predict}.java``).  Every
command that touches a model runs on ``--device`` (default ``cuda``;
``--device cpu`` for the CPU):

    python -m deeplearning4j_tpu_torch.cli train   --input iris.csv \\
        --conf net.json --output model.bin --epochs 50
    python -m deeplearning4j_tpu_torch.cli test    --input iris.csv \\
        --model model.bin
    python -m deeplearning4j_tpu_torch.cli predict --input iris.csv \\
        --model model.bin --output preds.csv
    python -m deeplearning4j_tpu_torch.cli telemetry --journal run.jsonl

``--input`` accepts a labeled numeric CSV (label in the last column, the
CSVDataFetcher convention) or the name of a built-in dataset
(``iris``, ``mnist[2d][-test]``).  ``--conf`` is MultiLayerConfiguration
JSON.  Model files are the reference's (``MultiLayerNetwork.to_bytes``),
so either package's ``train`` output loads in the other's ``test``.

Not ported: multi-process training (``--coordinator`` /
``--num-processes`` / ``--process-id`` beyond one process, ROADMAP A7)
and ``generate``, which serves through ``serving/router.Router``
(ROADMAP A4); both stay in the parser and exit naming their item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np


def _load_dataset(spec: str, binarize: bool = True):
    from deeplearning4j_tpu_torch.datasets.fetchers import (
        CSVDataFetcher, IrisDataFetcher, MnistDataFetcher)

    if spec == "iris":
        f = IrisDataFetcher()
        f.fetch(150)
    elif spec in ("mnist", "mnist-test", "mnist2d", "mnist2d-test"):
        # idx files when $MNIST_DIR (or ./data/mnist) holds them, else the
        # synthetic surrogate; "2d" keeps NHWC [N, 28, 28, 1] images for
        # conv nets, plain "mnist" flattens to [N, 784]; binarized at
        # 30/255 unless --raw-pixels
        f = MnistDataFetcher(train=not spec.endswith("-test"),
                             flatten=not spec.startswith("mnist2d"),
                             binarize=binarize)
        f.fetch(f.total)
    else:
        f = CSVDataFetcher(spec)
        f.fetch(10 ** 9)
    return f.next()


def _device(args):
    """``--device`` resolved; a missing card is a one-line exit."""
    from deeplearning4j_tpu_torch import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))


def _load_model(path: str, device):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with open(path, "rb") as fh:
        return MultiLayerNetwork.from_bytes(fh.read(), device=device)


def _refuse_multi_process(args) -> None:
    """The reference's multi-host launcher (flags over the DL4J_TPU_*
    env trio) is not ported: one process trains, more exit."""
    n = args.num_processes
    if n is None:
        n = int(os.environ.get("DL4J_TPU_NUM_PROCESSES") or 1)
    pid = args.process_id
    if pid is None:
        pid = int(os.environ.get("DL4J_TPU_PROCESS_ID") or 0)
    if n > 1 or pid > 0:
        raise SystemExit(
            f"multi-process training ({n} processes, this one {pid}) is not "
            "ported to the PyTorch package yet (ROADMAP A7); run one "
            "process")


def cmd_train(args) -> int:
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners import (
        ScoreIterationListener)
    from deeplearning4j_tpu_torch.runtime import telemetry

    if not args.checkpoint_dir and (args.resume or args.sync_checkpoints):
        # silently training from scratch here would overwrite --output
        # — exactly the data loss --resume exists to avoid
        raise SystemExit(
            "--resume/--sync-checkpoints require --checkpoint-dir")
    if args.checkpoint_dir and args.checkpoint_every <= 0:
        raise SystemExit("--checkpoint-every must be a positive step "
                         "count")
    _refuse_multi_process(args)
    device = _device(args)
    tracer = None
    journal_dir = args.telemetry
    if journal_dir is True:                 # bare --telemetry flag
        journal_dir = telemetry.DEFAULT_JOURNAL_DIR
    if journal_dir:
        tracer = telemetry.enable()
        telemetry.registry.mark()
    try:
        with open(args.conf) as fh:
            conf = MultiLayerConfiguration.from_json(fh.read())
        data = _load_dataset(args.input, binarize=not args.raw_pixels)
        net = MultiLayerNetwork(conf, device=device).init(seed=args.seed)
        net.set_listeners([ScoreIterationListener(args.log_every)])
        batches = (data.batch_by(args.batch) if args.batch > 0 else data)
        if args.checkpoint_dir:
            # preemption-tolerant path: async snapshots + signal guard;
            # SIGTERM mid-fit commits a final snapshot and returns here
            # cleanly (exit 0) — rerun with --resume to continue
            from deeplearning4j_tpu_torch.runtime.checkpoint import (
                CheckpointManager)
            from deeplearning4j_tpu_torch.runtime.resilience import (
                ResilienceConfig, ResilientFit)
            if conf.pretrain:
                raise SystemExit(
                    "--checkpoint-dir drives the backprop trainer; "
                    "pretrain confs must use the plain train path")
            # dir-state misuse fails BEFORE the finetune pass is spent,
            # as a one-line SystemExit
            latest = CheckpointManager(args.checkpoint_dir).latest_step()
            if args.resume and latest is None:
                raise SystemExit(
                    f"--resume: no checkpoints found in "
                    f"{args.checkpoint_dir} — wrong path or unmounted "
                    "volume? rerun without --resume for a fresh run")
            if not args.resume and latest is not None:
                raise SystemExit(
                    f"--checkpoint-dir {args.checkpoint_dir} already "
                    f"holds snapshots (latest step {latest}) — rerun "
                    "with --resume to continue that run, or point at a "
                    "fresh directory")
            # net.fit's own stage prep (the finetune pass) so adding
            # --checkpoint-dir never changes WHAT is trained; on a resume
            # the restore overwrites the finetuned params — harmless
            batch_list, mesh = net.prepare_resilient_fit(batches)
            driver = ResilientFit(net, ResilienceConfig(
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                resume=args.resume, sync=args.sync_checkpoints),
                mesh=mesh)
            driver.fit(batch_list, num_epochs=args.epochs, seed=args.seed)
            if driver.preempted:
                print(f"preempted: final snapshot committed at step "
                      f"{driver.manager.latest_step()} in "
                      f"{args.checkpoint_dir} — rerun with --resume")
                # the committed snapshot is this run's output: skip the
                # model write and the evaluation inside the grace window
                return 0
        else:
            net.fit(batches, num_epochs=args.epochs)
        with open(args.output, "wb") as fh:
            fh.write(net.to_bytes())
        ev = net.evaluate(data)
        print(f"saved model to {args.output}")
        print(f"train accuracy: {ev.accuracy():.4f}")
    finally:
        # export even when the fit raises or is interrupted — a failed
        # run is exactly when the journal is needed for the post-mortem
        if tracer is not None:
            os.makedirs(journal_dir, exist_ok=True)
            journal = os.path.join(journal_dir, f"{tracer.run_id}.jsonl")
            tracer.export_journal(journal,
                                  snapshot=telemetry.registry.snapshot())
            print(f"telemetry journal: {journal}  (summarize with "
                  f"`python -m deeplearning4j_tpu_torch.cli telemetry "
                  f"--journal {journal}`)")
    return 0


def cmd_test(args) -> int:
    net = _load_model(args.model, _device(args))
    data = _load_dataset(args.input, binarize=not args.raw_pixels)
    ev = net.evaluate(data)
    print(ev.stats())
    return 0


def cmd_predict(args) -> int:
    net = _load_model(args.model, _device(args))
    data = _load_dataset(args.input, binarize=not args.raw_pixels)
    preds = net.predict(data.features).cpu().numpy()
    if args.output:
        np.savetxt(args.output, preds, fmt="%d")
        print(f"wrote {len(preds)} predictions to {args.output}")
    else:
        for p in preds:
            print(int(p))
    return 0


def cmd_generate(args) -> int:
    raise SystemExit(
        "generate serves through serving/router.Router, which is not "
        "ported to the PyTorch package yet (ROADMAP A4)")


def cmd_telemetry(args) -> int:
    """Summarize a telemetry journal (runtime/telemetry.py JSONL): span
    tree with aggregate timings, top-k longest spans, event counts, and
    counter deltas between the journal's first and last registry
    snapshots.  ``--export-trace`` additionally converts the journal to
    chrome://tracing/Perfetto trace JSON."""
    from deeplearning4j_tpu_torch.runtime import telemetry

    records = telemetry.read_journal(args.journal)
    summary = telemetry.summarize_journal(records, top_k=args.top)

    if args.json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        for run in summary["runs"]:
            dropped = run.get("dropped", 0)
            print(f"run {run.get('run_id')}  (dropped records: {dropped})")
        print(f"{summary['n_spans']} span(s), "
              f"{summary['n_events']} event(s)")
        if summary["tree"]:
            print("\nspan tree (aggregated by name under parent):")
            print(f"  {'span':<44} {'count':>6} {'total ms':>10} "
                  f"{'mean ms':>9} {'max ms':>9}")
            for row in summary["tree"]:
                label = "  " * row["depth"] + row["name"]
                print(f"  {label:<44} {row['count']:>6} "
                      f"{row['total_ms']:>10.2f} {row['mean_ms']:>9.2f} "
                      f"{row['max_ms']:>9.2f}")
        if summary["top"]:
            print(f"\ntop {len(summary['top'])} spans by duration:")
            for r in summary["top"]:
                print(f"  {r['dur_ms']:>10.2f} ms  {r['name']}"
                      f"  @{r['ts']:.3f}s  {r['attrs'] or ''}")
        if summary["events"]:
            print("\nevents:")
            for name, n in sorted(summary["events"].items()):
                print(f"  {n:>6} x {name}")
        if "counter_deltas" in summary:
            print("\ncounter deltas (last snapshot - first):")
            print(json.dumps(summary["counter_deltas"], indent=2,
                             default=str))
        elif "counters" in summary:
            print("\ncounters (single snapshot):")
            print(json.dumps(summary["counters"], indent=2, default=str))

    if args.export_trace:
        run_id = summary["runs"][0].get("run_id", "run") \
            if summary["runs"] else "run"
        payload = telemetry.chrome_trace(records, run_id=run_id)
        with open(args.export_trace, "w") as fh:
            json.dump(payload, fh)
        print(f"\nwrote Perfetto trace JSON to {args.export_trace} "
              f"({len(payload['traceEvents'])} events) — load at "
              "https://ui.perfetto.dev or chrome://tracing")
    return 0


def _device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (default cuda; "
                        "'cpu' runs the CPU path)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="deeplearning4j on PyTorch/CUDA: train/test/predict")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="fit a model from a conf JSON")
    t.add_argument("--input", required=True,
                   help="labeled CSV path, or 'iris'/'mnist[2d][-test]' "
                        "(mnist reads $MNIST_DIR idx files when present)")
    t.add_argument("--conf", required=True,
                   help="MultiLayerConfiguration JSON file")
    t.add_argument("--output", required=True, help="model output path")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch", type=int, default=0,
                   help="minibatch size (0 = full batch)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--raw-pixels", action="store_true",
                   help="keep mnist pixels as [0,1] floats instead of the "
                        "reference's >30/255 binarization")
    t.add_argument("--log-every", type=int, default=10)
    t.add_argument("--telemetry", nargs="?", default=None, const=True,
                   metavar="DIR",
                   help="enable the run tracer and write a JSONL journal "
                        "into DIR (bare --telemetry uses the gitignored "
                        "'.dl4j_telemetry', or $DL4J_TPU_TELEMETRY_DIR)")
    t.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="train through the preemption-tolerant "
                        "ResilientFit driver: async background snapshots "
                        "into DIR, SIGTERM/SIGINT triggers a final "
                        "committed snapshot + clean exit 0")
    t.add_argument("--checkpoint-every", type=int, default=50,
                   metavar="STEPS", help="snapshot cadence in steps")
    t.add_argument("--resume", action="store_true",
                   help="continue from the newest committed checkpoint "
                        "in --checkpoint-dir")
    t.add_argument("--sync-checkpoints", action="store_true",
                   help="escape hatch: block the training thread on "
                        "every snapshot instead of the async writer")
    # the reference's multi-host launcher trio: parsed so the same
    # command lines work, refused beyond one process (ROADMAP A7)
    t.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process coordinator (not ported: ROADMAP "
                        "A7)")
    t.add_argument("--num-processes", type=int, default=None, metavar="N",
                   help="total processes (only 1 is ported: ROADMAP A7)")
    t.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="this process's rank (only 0 is ported)")
    _device_arg(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("test", help="evaluate a saved model")
    e.add_argument("--input", required=True)
    e.add_argument("--model", required=True)
    e.add_argument("--raw-pixels", action="store_true")
    _device_arg(e)
    e.set_defaults(fn=cmd_test)

    r = sub.add_parser("predict", help="class predictions for a dataset")
    r.add_argument("--input", required=True)
    r.add_argument("--model", required=True)
    r.add_argument("--output", default=None)
    r.add_argument("--raw-pixels", action="store_true")
    _device_arg(r)
    r.set_defaults(fn=cmd_predict)

    g = sub.add_parser(
        "generate",
        help="continuous-batching char-GPT text generation (not ported: "
             "ROADMAP A4)")
    g.add_argument("--input", default=None)
    g.add_argument("--params", default=None, metavar="NPZ")
    g.add_argument("--save-params", default=None, metavar="NPZ")
    g.add_argument("--prompt", action="append", default=None)
    g.add_argument("--max-tokens", type=int, default=48)
    g.add_argument("--temperature", type=float, default=0.3)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--max-len", type=int, default=128)
    g.add_argument("--train-steps", type=int, default=300)
    g.add_argument("--replicas", type=int, default=1)
    g.add_argument("--slots", type=int, default=8)
    g.add_argument("--max-queue-depth", type=int, default=64)
    g.add_argument("--timeout", type=float, default=300.0)
    g.add_argument("--telemetry", nargs="?", default=None, const=True,
                   metavar="DIR")
    g.set_defaults(fn=cmd_generate)

    m = sub.add_parser(
        "telemetry",
        help="summarize a run-telemetry journal (span tree, top-k "
             "durations, counter deltas; optional Perfetto export)")
    m.add_argument("--journal", required=True,
                   help="JSONL journal written by "
                        "runtime/telemetry.py export_journal()")
    m.add_argument("--top", type=int, default=10,
                   help="how many longest spans to list")
    m.add_argument("--json", action="store_true",
                   help="emit the summary as JSON instead of text")
    m.add_argument("--export-trace", default=None, metavar="PATH",
                   help="also convert the journal to chrome://tracing/"
                        "Perfetto trace JSON at PATH")
    m.set_defaults(fn=cmd_telemetry)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
