"""Command-line interface: train / test / predict / generate / telemetry.

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

``generate`` serves a char-level GPT through ``serving/router.Router``
replicas of ``DecodeEngine`` (every ``--prompt`` decodes concurrently),
trained on the fly from ``--input`` text or loaded from ``--params``, an
npz that either package's ``generate --save-params`` writes:

    python -m deeplearning4j_tpu_torch.cli generate --train-steps 300 \
        --save-params g.npz --prompt "the quick " --prompt "a lazy "
    python -m deeplearning4j_tpu_torch.cli generate --params g.npz \
        --temperature 0 --prompt "the quick "

``train`` spans processes as the reference's does: every process runs
the same command with its own ``--process-id`` (or the
``DL4J_TPU_COORDINATOR`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` trio) and
a ``--checkpoint-dir`` on a filesystem they share; the processes join one
``torch.distributed`` group (gloo on the CPU, or for several processes
on one card) and train through ``ResilientFit`` with cluster-committed
snapshots:

    python -m deeplearning4j_tpu_torch.cli train --input iris.csv \
        --conf net.json --output model.bin --checkpoint-dir ck \
        --coordinator file:///shared/rdv --num-processes 2 --process-id 0
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


def _join_cluster(args, device):
    """The reference's multi-process launcher (:76-100): the flags
    merged with the ``DL4J_TPU_*`` trio, ``--checkpoint-dir`` required
    beyond one process, the group joined with a bounded retry (several
    ranks on one card, or on the CPU, over gloo).  The cluster, or None
    for one process."""
    from deeplearning4j_tpu_torch.parallel import multihost

    try:
        cluster_cfg = multihost.resolve_cluster_config(
            args.coordinator, args.num_processes, args.process_id)
    except ValueError as e:
        raise SystemExit(str(e))
    if cluster_cfg is None or cluster_cfg.num_processes == 1:
        return None
    if not args.checkpoint_dir:
        raise SystemExit(
            "multi-process training requires --checkpoint-dir: "
            "cluster-committed snapshots (on a filesystem every "
            "host shares) are the substrate preemption and "
            "host-loss recovery coordinate through")
    import torch

    backend = ("gloo" if device.type != "cuda" or torch.cuda.device_count()
               < cluster_cfg.num_processes else None)
    try:
        cluster = multihost.initialize(cluster_cfg, device=device,
                                       backend=backend)
    except multihost.ClusterJoinError as e:
        raise SystemExit(f"cluster join failed: {e}")
    print(f"joined cluster: process {cluster.process_id} of "
          f"{cluster.process_count} at {cluster_cfg.coordinator}")
    return cluster


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
    device = _device(args)
    # multi-process: join, and hand the cluster to ResilientFit below
    cluster = _join_cluster(args, device)
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
            resilient = ResilientFit(net, ResilienceConfig(
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                resume=args.resume, sync=args.sync_checkpoints),
                mesh=mesh, cluster=cluster)
            resilient.fit(batch_list, num_epochs=args.epochs, seed=args.seed)
            if resilient.evicted:
                print("host loss: this process's devices were lost — "
                      "exiting cleanly; the surviving hosts carry the "
                      "run (resume from the cluster-committed "
                      f"snapshots in {args.checkpoint_dir})")
                return 0
            if resilient.preempted:
                print(f"preempted: final snapshot committed at step "
                      f"{resilient.manager.latest_step()} in "
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


def _gpt_save_npz(path: str, cfg, params, chars: str) -> None:
    """A char-GPT as one .npz (cli.py:213): the nested params flattened
    to slash-joined keys, plus a JSON header with the config and the
    vocabulary; the JAX package's ``_gpt_load_npz`` reads it."""
    import dataclasses

    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = (node.detach().cpu().numpy()
                            if hasattr(node, "detach") else np.asarray(node))

    walk("", params)
    header = json.dumps({"cfg": dataclasses.asdict(cfg), "chars": chars})
    np.savez(path, __conf__=np.asarray(header), **flat)


def _gpt_load_npz(path: str):
    """``(cfg, params as numpy, chars)`` of an npz :func:`_gpt_save_npz`
    (or the JAX package's) wrote."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__conf__"]))
    params: dict = {}
    for key in data.files:
        if key == "__conf__":
            continue
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return TransformerConfig(**meta["cfg"]), params, meta["chars"]


def _train_char_gpt(args, text: str, device):
    """A char-level ``gpt_tiny`` trained ``--train-steps`` steps on
    ``text`` through ``gpt.make_train_step`` (its defaults: adamw, the
    flash kernels on CUDA where the shape suits them): ``(cfg, params
    as numpy, chars)``."""
    import torch

    from deeplearning4j_tpu_torch.models import gpt

    chars = "".join(sorted(set(text)))
    stoi = {c: i for i, c in enumerate(chars)}
    ids = np.asarray([stoi[c] for c in text], np.int32)
    cfg = gpt.gpt_tiny(vocab_size=len(chars), max_len=args.max_len)
    init_fn, step_fn = gpt.make_train_step(cfg, device=device)
    state = init_fn(torch.Generator(device=device).manual_seed(args.seed))
    T = min(32, cfg.max_len)
    reps = -(-(T + 1) // ids.size)
    if reps > 1:
        ids = np.tile(ids, reps)
    n = max((ids.size - 1) // T, 1)
    x = torch.from_numpy(ids[:n * T].reshape(n, T)).to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    print(f"training char-GPT ({args.train_steps} steps, vocab "
          f"{len(chars)}, {n} x {T} tokens a step) ...")
    loss = None
    for _ in range(args.train_steps):
        state, loss = step_fn(state, x, gen)
    if loss is not None:
        print(f"final LM loss: {float(loss):.3f}")
    params = {grp: {k: v.detach().cpu().numpy() for k, v in leaves.items()}
              for grp, leaves in state.params.items()}
    return cfg, params, chars


def cmd_generate(args) -> int:
    """Continuous-batching text generation (serving/decode.py, cli.py:
    261): every ``--prompt`` is served concurrently through ``Router``
    replicas of the slot-structured ``DecodeEngine``, joining the
    running decode batch mid-flight.  The model is a char-level GPT,
    loaded from ``--params`` or trained on the fly from ``--input``
    text (default: a built-in phrase)."""
    import time as _time

    from deeplearning4j_tpu_torch.runtime import telemetry
    from deeplearning4j_tpu_torch.runtime.metrics import decode_metrics
    from deeplearning4j_tpu_torch.serving.router import (OverloadedError,
                                                         Router)

    device = _device(args)
    tracer = None
    journal_dir = args.telemetry
    if journal_dir is True:
        journal_dir = telemetry.DEFAULT_JOURNAL_DIR
    if journal_dir:
        tracer = telemetry.enable()

    if args.params:
        cfg, params, chars = _gpt_load_npz(args.params)
        print(f"loaded char-GPT from {args.params} "
              f"(vocab {cfg.vocab_size}, max_len {cfg.max_len})")
    else:
        if args.input:
            with open(args.input) as fh:
                text = fh.read()
        else:
            text = "the quick brown fox jumps over the lazy dog. " * 64
        cfg, params, chars = _train_char_gpt(args, text, device)
        if args.save_params:
            _gpt_save_npz(args.save_params, cfg, params, chars)
            print(f"saved params to {args.save_params}")

    stoi = {c: i for i, c in enumerate(chars)}
    prompts = args.prompt or ["the quick "]
    enc = [np.asarray([stoi.get(c, 0) for c in p], np.int32)
           for p in prompts]

    telemetry.registry.mark()
    router = Router.replicate(
        cfg, params, args.replicas, n_slots=args.slots,
        max_queue_depth=args.max_queue_depth,
        default_max_tokens=args.max_tokens, device=device)
    t0 = _time.perf_counter()
    with router:
        handles = []
        for p, e in zip(prompts, enc):
            try:
                handles.append((p, router.submit(
                    e, max_tokens=args.max_tokens,
                    temperature=args.temperature, seed=args.seed)))
            except OverloadedError as err:
                print(f"SHED  {p!r}: {err}")
        for p, h in handles:
            toks = h.result(args.timeout)
            text_out = "".join(chars[t] if t < len(chars) else "?"
                               for t in toks)
            print(f"{p!r} -> {p + text_out!r}")
    wall = _time.perf_counter() - t0
    snap = decode_metrics.snapshot()
    print(f"\n{snap['tokens_out']} tokens in {wall:.2f}s "
          f"({snap['tokens_out'] / max(wall, 1e-9):.1f} tok/s) | "
          f"ttft p50/p99 {snap['ttft_p50_ms']}/{snap['ttft_p99_ms']} ms | "
          f"slot occupancy {snap['slot_occupancy']:.2f} | "
          f"joins {snap['joins']} | compile_delta "
          f"{snap.get('compile_delta_since_mark')}")
    if tracer is not None:
        os.makedirs(journal_dir, exist_ok=True)
        journal = os.path.join(journal_dir, f"{tracer.run_id}.jsonl")
        tracer.export_journal(journal,
                              snapshot=telemetry.registry.snapshot())
        print(f"telemetry journal: {journal}")
    return 0


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
        description="deeplearning4j on PyTorch/CUDA: train/test/predict/"
                    "generate")
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
    # the multi-process launcher trio (parallel/multihost.py owns the
    # contract): every process runs the same command with its own
    # --process-id (or the DL4J_TPU_* environment trio)
    t.add_argument("--coordinator", default=None, metavar="URL",
                   help="rendezvous of the process group: file:///path "
                        "(on a filesystem every process shares), "
                        "tcp://host:port or host:port (env: "
                        "DL4J_TPU_COORDINATOR)")
    t.add_argument("--num-processes", type=int, default=None, metavar="N",
                   help="total processes in the cluster (env: "
                        "DL4J_TPU_NUM_PROCESSES)")
    t.add_argument("--process-id", type=int, default=None, metavar="I",
                   help="this process's rank (env: DL4J_TPU_PROCESS_ID)")
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
        help="continuous-batching char-GPT text generation "
             "(serving/decode.py): all --prompt requests decode "
             "concurrently in one slot-structured batch")
    g.add_argument("--input", default=None,
                   help="text file to build the char vocab from and "
                        "train on (default: a built-in demo phrase)")
    g.add_argument("--params", default=None, metavar="NPZ",
                   help="load a char-GPT saved by --save-params instead "
                        "of training")
    g.add_argument("--save-params", default=None, metavar="NPZ",
                   help="save the freshly trained char-GPT for reuse")
    g.add_argument("--prompt", action="append", default=None,
                   help="prompt text (repeatable; each one is a "
                        "concurrent request)")
    g.add_argument("--max-tokens", type=int, default=48)
    g.add_argument("--temperature", type=float, default=0.3,
                   help="0 = greedy argmax")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--max-len", type=int, default=128,
                   help="model context length (prompt + continuation "
                        "must fit)")
    g.add_argument("--train-steps", type=int, default=300)
    g.add_argument("--replicas", type=int, default=1,
                   help="decode engine replicas behind the router")
    g.add_argument("--slots", type=int, default=8,
                   help="concurrent sequences per engine")
    g.add_argument("--max-queue-depth", type=int, default=64,
                   help="router load-shed bound (OverloadedError above)")
    g.add_argument("--timeout", type=float, default=300.0)
    g.add_argument("--telemetry", nargs="?", default=None, const=True,
                   metavar="DIR",
                   help="enable the run tracer and write a JSONL journal")
    _device_arg(g)
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
