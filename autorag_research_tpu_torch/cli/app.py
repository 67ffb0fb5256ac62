"""Command-line interface.

UX parity with the reference Typer CLI (``cli/app.py:35-92`` and
``cli/commands/*``): ``init, show, ingest, run, report, data, drop, plugin,
health-check, serve`` — implemented with argparse.

The "database" is a workspace directory holding ``catalog.db`` plus saved
index artifacts — the role Postgres databases play in the reference.
``data dump/restore`` tars the workspace (the ``pg_dump``/``pg_restore``
analogue, ``orm/connection.py:298-486``).

The port's copy of the JAX package's ``cli/app.py``. The global ``--device``
(``cuda`` by default, or ``cpu``) is where ``ingest``, ``run``, ``train``,
``serve`` and ``health-check`` build their models, indexes and pipelines;
asked for ``cuda`` on a machine with no GPU, they fail rather than run on the
CPU. ``run --mesh`` and ``serve --mesh`` shard the indexes over every visible
card (``parallel/mesh.py::device_corpus_mesh``; one card, or ``--device
cpu``, runs unsharded); ``train --model bi --mesh`` trains over a ``(dp, tp)``
mesh of them (``parallel/mesh.py::device_train_mesh``, the JAX CLI's rule).
``show dumps`` and ``data upload`` / ``download`` reach the HF Hub
(``data/hf_storage.py``).

Entry point: ``python -m autorag_research_tpu_torch.cli ...``
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import tarfile
from pathlib import Path

logger = logging.getLogger("AutoRAG-Research-TPU")


def _setup_logging(verbose: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


def _check_device(device: str) -> str | None:
    """The error of a device that cannot run here, else None."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        return "--device cuda: no CUDA GPU found (pass --device cpu to run on the CPU)"
    return None


def _open_catalog(db: str):
    from autorag_research_tpu_torch.store.catalog import Catalog

    path = Path(db)
    if path.is_dir() or not path.suffix:
        path.mkdir(parents=True, exist_ok=True)
        return Catalog(path / "catalog.db")
    return Catalog(path)


# ---------------------------------------------------------------------- run
def cmd_run(args) -> int:
    from autorag_research_tpu_torch.cli.config_resolver import ConfigResolver
    from autorag_research_tpu_torch.config import BuildContext
    from autorag_research_tpu_torch.executor import Executor
    from autorag_research_tpu_torch.injection import ModelRegistry

    mesh = None
    if args.mesh:
        from autorag_research_tpu_torch.parallel.mesh import device_corpus_mesh

        mesh = device_corpus_mesh(args.device)
    resolver = ConfigResolver(args.config_path)
    config = resolver.load_experiment(args.experiment)
    catalog = _open_catalog(args.db)
    context = BuildContext(
        device=args.device,
        models=ModelRegistry(args.config_path, device=args.device),
        pipeline_configs=dict(getattr(config, "extra_pipeline_configs", {})),
        mesh=mesh,
    )
    result = Executor(catalog, config, context).run()
    print(result.report())
    return 0 if result.success else 1


# -------------------------------------------------------------------- ingest
def cmd_ingest(args) -> int:
    from autorag_research_tpu_torch.data.registry import get_ingestor
    from autorag_research_tpu_torch.injection import ModelRegistry
    from autorag_research_tpu_torch.store.ingestion import IngestionService

    info = get_ingestor(args.name)
    extra = {}
    for kv in args.extra or []:
        key, _, value = kv.partition("=")
        key = key.replace("-", "_")
        for p in info.params:
            if p.name == key and p.annotation in (int, float):
                value = p.annotation(value)
        extra[key] = value

    embedding_model = None
    if args.embedding_model:
        embedding_model = ModelRegistry(args.config_path, device=args.device).load_embedding(
            args.embedding_model
        )
    ingestor = info.cls(embedding_model=embedding_model, **extra)

    catalog = _open_catalog(args.db)
    ingestor.set_service(IngestionService(catalog))
    ingestor.ingest(
        subset=args.subset, query_limit=args.query_limit, min_corpus_cnt=args.min_corpus_cnt
    )
    print(json.dumps(catalog.stats(), indent=2))
    if embedding_model is not None and not args.skip_embed:
        if args.late_interaction:
            stats = ingestor.embed_all_late_interaction()
        else:
            stats = ingestor.embed_all()
        for table, s in stats.items():
            print(f"embedded {table}: {s.embedded}/{s.total} (failed: {len(s.failed_ids)})")
    return 0


# ---------------------------------------------------------------------- show
def cmd_show(args) -> int:
    what = args.what
    if what == "ingestors" or what == "datasets":
        from autorag_research_tpu_torch.data.registry import list_ingestors

        for info in list_ingestors():
            params = ", ".join(
                f"{p.name}={p.default!r}" if not p.required else p.name for p in info.params
            )
            print(f"{info.name:16s} {info.description}  ({params})")
    elif what == "pipelines":
        from autorag_research_tpu_torch.config import BasePipelineConfig
        import autorag_research_tpu_torch.pipelines.generation  # noqa: F401
        import autorag_research_tpu_torch.pipelines.retrieval  # noqa: F401

        for name, cls in sorted(BasePipelineConfig.registry.items()):
            print(f"{name:28s} [{cls.kind}]")
    elif what == "metrics":
        from autorag_research_tpu_torch.evaluation.metrics.generation import GENERATION_METRICS
        from autorag_research_tpu_torch.evaluation.metrics.retrieval import RETRIEVAL_METRICS

        for name in RETRIEVAL_METRICS:
            print(f"{name:28s} [retrieval]")
        for name in GENERATION_METRICS:
            print(f"{name:28s} [generation]")
    elif what == "databases":
        root = Path(args.root or ".")
        for p in sorted(root.glob("**/catalog.db")):
            print(p.parent)
    elif what == "dumps":
        # prebuilt-workspace dumps on HF Hub (reference cli/commands/show.py:30-186)
        import os

        from autorag_research_tpu_torch.data.hf_storage import DEFAULT_ORG, list_dumps
        from autorag_research_tpu_torch.data.registry import list_ingestors
        from autorag_research_tpu_torch.exceptions import StoreError

        names = [args.ingestor] if args.ingestor else [i.name for i in list_ingestors()]
        token = os.environ.get("HF_TOKEN")
        for name in names:
            try:
                dumps = list_dumps(name, org=args.org or DEFAULT_ORG, token=token)
            except StoreError as exc:
                print(f"{name:16s} <unavailable: {exc}>", file=sys.stderr)
                continue
            for d in dumps:
                print(f"{name:16s} {d}")
    else:
        print(f"unknown 'show {what}'", file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------- data
def _dump_workspace(workspace: Path, out: Path) -> int:
    if not workspace.exists():
        print(f"{workspace} does not exist", file=sys.stderr)
        return 1
    with tarfile.open(out, "w:gz") as tar:
        tar.add(workspace, arcname=workspace.name)
    print(f"dumped {workspace} -> {out}")
    return 0


def _restore_tarball(src: Path, workspace: Path) -> int:
    import shutil
    import tempfile

    if workspace.exists():
        print(f"refusing to restore over existing {workspace}", file=sys.stderr)
        return 1
    workspace.parent.mkdir(parents=True, exist_ok=True)
    # extract into a scratch dir first so an archive whose root collides
    # with an existing workspace can never merge into or move it
    with tempfile.TemporaryDirectory(dir=workspace.parent) as tmp:
        with tarfile.open(src, "r:gz") as tar:
            tar.extractall(tmp, filter="data")
        roots = list(Path(tmp).iterdir())
        if len(roots) != 1:
            print(f"unexpected archive layout: {[r.name for r in roots]}", file=sys.stderr)
            return 1
        shutil.move(str(roots[0]), str(workspace))
    print(f"restored {src} -> {workspace}")
    return 0


def cmd_data(args) -> int:
    """dump/restore locally; upload/download distribute dumps via HF Hub
    dataset repos (reference ``cli/commands/data.py:33-200`` +
    ``data/hf_storage.py:17-152``)."""
    import os

    from autorag_research_tpu_torch.exceptions import StoreError

    workspace = Path(args.db)
    token = os.environ.get("HF_TOKEN")
    if args.action == "dump":
        return _dump_workspace(workspace, Path(args.file or f"{workspace.name}.dump.tar.gz"))
    if args.action == "restore":
        return _restore_tarball(Path(args.file), workspace)
    if args.action == "upload":
        from autorag_research_tpu_torch.data.hf_storage import DEFAULT_ORG, upload_dump

        ingestor = args.ingestor or workspace.name
        dump = Path(args.file or f"{workspace.name}.dump.tar.gz")
        if not dump.exists():
            rc = _dump_workspace(workspace, dump)
            if rc:
                return rc
        try:
            ref = upload_dump(dump, ingestor, org=args.org or DEFAULT_ORG, token=token)
        except StoreError as exc:
            print(str(exc), file=sys.stderr)
            return 1
        print(f"uploaded {dump} -> hf://datasets/{ref}")
        return 0
    if args.action == "download":
        import tempfile

        from autorag_research_tpu_torch.data.hf_storage import DEFAULT_ORG, download_dump

        if not args.ingestor:
            print("data download requires --ingestor", file=sys.stderr)
            return 1
        if workspace.exists():
            print(f"refusing to restore over existing {workspace}", file=sys.stderr)
            return 1
        dump_name = args.file or f"{workspace.name}.dump.tar.gz"
        with tempfile.TemporaryDirectory() as tmp:
            try:
                path = download_dump(
                    args.ingestor, dump_name, tmp, org=args.org or DEFAULT_ORG, token=token
                )
            except StoreError as exc:
                print(str(exc), file=sys.stderr)
                return 1
            return _restore_tarball(path, workspace)
    return 0


# ---------------------------------------------------------------------- drop
def cmd_drop(args) -> int:
    import shutil

    workspace = Path(args.db)
    if not workspace.exists():
        print(f"{workspace} does not exist", file=sys.stderr)
        return 1
    if not args.yes:
        reply = input(f"drop workspace {workspace}? [y/N] ")
        if reply.lower() != "y":
            return 1
    if workspace.is_dir():
        shutil.rmtree(workspace)
    else:
        workspace.unlink()
    print(f"dropped {workspace}")
    return 0


# -------------------------------------------------------------- health-check
def cmd_health_check(args) -> int:
    import torch

    from autorag_research_tpu_torch.injection import ModelRegistry

    ok = True
    if args.db:
        db_path = Path(args.db)
        target = db_path / "catalog.db" if (db_path.is_dir() or not db_path.suffix) else db_path
        if not target.exists():
            print(f"db FAILED: no catalog at {target}")
            ok = False
        else:
            try:
                catalog = _open_catalog(args.db)
                stats = catalog.stats()
                print(f"db ok: {stats}")
            except Exception as exc:  # noqa: BLE001
                print(f"db FAILED: {exc}")
                ok = False
    registry = ModelRegistry(args.config_path, device=args.device)
    for kind, name in (("llm", args.llm), ("embedding", args.embedding), ("reranker", args.reranker)):
        if not name:
            continue
        try:
            getattr(registry, f"load_{kind}")(name)
            print(f"{kind} '{name}' ok")
        except Exception as exc:  # noqa: BLE001
            print(f"{kind} '{name}' FAILED: {exc}")
            ok = False
    if torch.cuda.is_available():
        print(f"torch {torch.__version__}, device {args.device}; cuda devices: "
              f"{torch.cuda.device_count()} ({torch.cuda.get_device_name()})")
    else:
        print(f"torch {torch.__version__}, device {args.device}; cuda devices: 0")
    return 0 if ok else 1


# ---------------------------------------------------------------------- init
def cmd_init(args) -> int:
    from autorag_research_tpu_torch.cli.templates import write_default_configs

    target = Path(args.config_path)
    written = write_default_configs(target, overwrite=args.force)
    for p in written:
        print(f"wrote {p}")
    if not written:
        print("all config files already exist (use --force to overwrite)")
    return 0


# -------------------------------------------------------------------- plugin
def cmd_plugin(args) -> int:
    from autorag_research_tpu_torch.plugin_registry import (
        create_plugin_scaffold,
        sync_plugin_configs,
    )

    if args.action == "create":
        path = create_plugin_scaffold(args.name, Path(args.dir or "."))
        print(f"created plugin scaffold at {path}")
    elif args.action == "sync":
        copied = sync_plugin_configs(Path(args.config_path))
        for p in copied:
            print(f"synced {p}")
        if not copied:
            print("no plugin configs found to sync")
    return 0


# ------------------------------------------------------------------- report
def cmd_report(args) -> int:
    from autorag_research_tpu_torch.reporting.service import ReportingService

    service = ReportingService([Path(d) for d in args.db])
    df = service.leaderboard()
    if df.empty:
        print("no evaluation results found")
        if not (args.ui or args.html):
            return 1
        # --ui / --html still proceed: the live UI's whole point is that a
        # refresh during (or right after) an experiment shows current numbers
    else:
        print(df.to_string(index=False))
    if args.html:
        from autorag_research_tpu_torch.reporting.html import write_html_report

        out = write_html_report(service, Path(args.html))
        print(f"wrote {out}")
    if args.ui:
        import time

        from autorag_research_tpu_torch.reporting.ui import serve_report

        handle = serve_report(args.db, port=args.ui_port)
        print(f"leaderboard UI at {handle.url} (Ctrl-C to stop)")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            handle.shutdown()
    return 0


def cmd_train(args) -> int:
    """Fine-tune the native bi-encoder, cross-encoder or LM on a workspace's
    ground truth, on ``--device``, and save its weights as the flat ``.npz``
    that ``torch_encoder`` (``params_path``), ``torch_cross_encoder``
    (``params_path``) and ``torch_lm`` (``checkpoint``) load."""
    from autorag_research_tpu_torch.models.encoder import EncoderConfig

    catalog = _open_catalog(args.db)
    cfg_kwargs = {}
    if args.hidden:
        cfg_kwargs.update(hidden=args.hidden, out_dim=args.hidden // 2)
    if args.layers:
        cfg_kwargs["layers"] = args.layers
    config = EncoderConfig(**cfg_kwargs) if cfg_kwargs else None

    if args.model == "lm":
        from autorag_research_tpu_torch.models.decoder import DecoderConfig
        from autorag_research_tpu_torch.models.lm_trainer import LMTrainer

        lm_kwargs = {}
        if args.hidden:
            lm_kwargs["hidden"] = args.hidden
        if args.layers:
            lm_kwargs["layers"] = args.layers
        if args.seq_len * 2 > DecoderConfig.max_len:
            lm_kwargs["max_len"] = args.seq_len * 2  # room to decode after a prompt
        lm_config = DecoderConfig(**lm_kwargs) if lm_kwargs else None
        trainer = LMTrainer(
            lm_config, lr=args.lr, batch_size=args.batch_size, seq_len=args.seq_len,
            device=args.device,
        )
        report = trainer.train(
            catalog, epochs=args.epochs, max_steps=args.max_steps, log_every=10
        )
    elif args.model == "cross":
        from autorag_research_tpu_torch.models.cross_encoder import CrossEncoderTrainer

        trainer = CrossEncoderTrainer(
            config, lr=args.lr, batch_size=args.batch_size, device=args.device
        )
        report = trainer.train(catalog, epochs=args.epochs, max_steps=args.max_steps)
    else:
        from autorag_research_tpu_torch.models.trainer import BiEncoderTrainer

        mesh = None
        if args.mesh:
            from autorag_research_tpu_torch.parallel.mesh import device_train_mesh

            mesh = device_train_mesh(args.device)
        trainer = BiEncoderTrainer(
            config, lr=args.lr, batch_size=args.batch_size,
            optimizer=args.optimizer, mesh=mesh, device=args.device,
        )
        report = trainer.train(
            catalog, epochs=args.epochs, max_steps=args.max_steps,
            checkpoint_dir=args.checkpoint_dir,
        )
    print(
        f"trained {report.steps} steps in {report.seconds:.1f}s "
        f"(loss {report.losses[0]:.4f} -> {report.final_loss:.4f})"
    )
    trainer.save(args.out)
    print(f"saved params to {args.out}")
    return 0


def cmd_serve(args) -> int:
    from autorag_research_tpu_torch.serving.server import serve_workspace

    handle = serve_workspace(
        args.db,
        config_path=args.config_path,
        retrieval=args.retrieval,
        generation=args.generation,
        host=args.host,
        port=args.port,
        mesh=args.mesh,
        device=args.device,
    )
    print(f"serving {args.db} on http://{args.host}:{handle.port} (ctrl-c to stop)")
    try:
        import signal

        signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    finally:
        handle.stop()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="autorag-research-tpu-torch",
        description="RAG research framework on PyTorch + CUDA",
    )
    parser.add_argument("--config-path", default="./configs", help="config tree root")
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where models, indexes and pipelines run (default: cuda; no fallback)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    # on_device: the command builds models, indexes or pipelines on --device
    p = sub.add_parser("run", help="run the configured experiment")
    p.add_argument("--db", required=True, help="workspace dir or catalog file")
    p.add_argument("--experiment", default=None, help="experiment yaml (default configs/experiment.yaml)")
    p.add_argument("--mesh", action="store_true", help="shard indexes over all visible cards")
    p.set_defaults(func=cmd_run, on_device=True)

    p = sub.add_parser(
        "train", help="fine-tune the native encoder / cross-encoder / LM on workspace GT"
    )
    p.add_argument("--db", required=True)
    p.add_argument("--model", choices=["bi", "cross", "lm"], default="bi")
    p.add_argument(
        "--seq-len", type=int, default=256,
        help="(lm) training sequence budget: prompt + answer bytes",
    )
    p.add_argument("--out", required=True, help="output params .npz path")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--optimizer", choices=["sgd", "adamw"], default="adamw")
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--mesh", action="store_true", help="(bi) shard over a (dp, tp) mesh")
    p.add_argument("--checkpoint-dir", default=None, help="(bi) save / auto-resume dir")
    p.set_defaults(func=cmd_train, on_device=True)

    p = sub.add_parser("ingest", help="ingest a benchmark dataset")
    p.add_argument("--name", required=True)
    p.add_argument("--db", required=True)
    p.add_argument("--subset", default="test")
    p.add_argument("--query-limit", type=int, default=None)
    p.add_argument("--min-corpus-cnt", type=int, default=None)
    p.add_argument("--embedding-model", default=None)
    p.add_argument("--late-interaction", action="store_true")
    p.add_argument("--skip-embed", action="store_true")
    p.add_argument("--extra", action="append", help="k=v ingestor params", default=None)
    p.set_defaults(func=cmd_ingest, on_device=True)

    p = sub.add_parser("show", help="list datasets/ingestors/pipelines/metrics/databases")
    p.add_argument(
        "what",
        choices=["datasets", "ingestors", "pipelines", "metrics", "databases", "dumps"],
    )
    p.add_argument("--root", default=None)
    p.add_argument("--ingestor", default=None, help="(dumps) ingestor to list hub dumps for")
    p.add_argument("--org", default=None, help="(dumps) HF org for dump repos")
    p.set_defaults(func=cmd_show)

    p = sub.add_parser("data", help="dump/restore workspace artifacts")
    p.add_argument("action", choices=["dump", "restore", "upload", "download"])
    p.add_argument("--db", required=True)
    p.add_argument("--file", default=None,
                   help="dump tarball path (local) or dump filename (hub)")
    p.add_argument("--ingestor", default=None,
                   help="ingestor name keying the hub dump repo ({org}/{ingestor}-dumps)")
    p.add_argument("--org", default=None, help="HF org for dump repos")
    p.set_defaults(func=cmd_data)

    p = sub.add_parser("drop", help="delete a workspace")
    p.add_argument("--db", required=True)
    p.add_argument("-y", "--yes", action="store_true")
    p.set_defaults(func=cmd_drop)

    p = sub.add_parser("health-check", help="probe db / models / devices")
    p.add_argument("--db", default=None)
    p.add_argument("--llm", default=None)
    p.add_argument("--embedding", default=None)
    p.add_argument("--reranker", default=None)
    p.set_defaults(func=cmd_health_check, on_device=True)

    p = sub.add_parser("init", help="write the default config tree")
    p.add_argument("--force", action="store_true")
    p.set_defaults(func=cmd_init)

    p = sub.add_parser("plugin", help="plugin scaffolding / config sync")
    p.add_argument("action", choices=["create", "sync"])
    p.add_argument("--name", default="my_plugin")
    p.add_argument("--dir", default=None)
    p.set_defaults(func=cmd_plugin)

    p = sub.add_parser("report", help="leaderboard over one or more workspaces")
    p.add_argument("--db", required=True, action="append",
                   help="workspace (repeat for cross-dataset comparison)")
    p.add_argument("--html", default=None, help="also write an HTML report")
    p.add_argument("--ui", action="store_true",
                   help="serve a live leaderboard web UI (re-reads on refresh)")
    p.add_argument("--ui-port", type=int, default=8090)
    p.set_defaults(func=cmd_report)

    p = sub.add_parser("serve", help="serve a workspace over HTTP (/search, /generate)")
    p.add_argument("--db", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--retrieval", action="append", default=None, help="pipeline names")
    p.add_argument("--generation", action="append", default=None)
    p.add_argument("--mesh", action="store_true", help="shard indexes over all visible cards")
    p.set_defaults(func=cmd_serve, on_device=True)

    return parser


def main(argv: list[str] | None = None) -> int:
    import signal

    # behave like a unix tool when piped into head etc.
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    parser = build_parser()
    args = parser.parse_args(argv)
    _setup_logging(args.verbose)
    if getattr(args, "on_device", False):
        error = _check_device(args.device)
        if error:
            print(error, file=sys.stderr)
            return 2
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
