"""Serving CLI: load a checkpoint and run the HTTP enhancement server (port
of diffse_tpu/cli/serve.py). Usage:

    python -m diffse_tpu_torch.cli.serve --ckpt runs/my_model --port 8080
    curl -s --data-binary @noisy.wav http://127.0.0.1:8080/enhance > out.wav
    curl -s http://127.0.0.1:8080/stats

Concurrent requests are pooled into fixed-shape chunk batches by the dynamic
batcher (diffse_tpu_torch/serving/service.py); on the card one captured
chunk program serves every length. SNR-adaptive checkpoints estimate each
request's SNR (``--snr_ckpt``) unless the client passes ``?est_snr=``. The
served weights are the checkpoint's EMA, as at evaluation. The port adds
``--device`` (the card unless "cpu" is given).

``--artifact DIR`` serves an exported enhance program instead
(``serving/export.py``, written by ``python -m
diffse_tpu_torch.cli.export_artifact``, any branch, float32 or bf16 trunk):
one utterance a request, no model code, on the device it was exported for,
each bucket's programs captured at load (``bbed_ode`` loops its attempt
program on the host); an artifact holds no SNR estimator, so clients of a
``*_snr`` artifact pass ``?est_snr=``. Exactly
one of ``--ckpt`` / ``--artifact``; ``--snr_ckpt``, ``--ckpt_step`` and
``--monitor`` apply to ``--ckpt`` only.
"""

from __future__ import annotations

import argparse


def main(argv=None, block=True):
    """``block=False`` starts the server and returns ``(server, service,
    thread)`` instead of serving until interrupted."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint directory (hparams.json + steps)")
    parser.add_argument("--artifact", type=str, default=None,
                        help="exported enhance program directory (cli.export_artifact)")
    parser.add_argument("--ckpt_step", type=int, default=None)
    parser.add_argument("--monitor", type=str, default=None,
                        help="pick the best step by this metric instead of the latest")
    parser.add_argument("--snr_ckpt", type=str, default=None,
                        help="SNR-estimator checkpoint for the *_snr branches")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--chunk_frames", type=int, default=64)
    parser.add_argument("--overlap_frames", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--max_flight_utts", type=int, default=16)
    parser.add_argument("--max_wait_ms", type=float, default=25.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--predictor", type=str, default=None,
                        help="bbed sampler predictor override (e.g. 'heun' with --corrector "
                             "none --sampler_n 15)")
    parser.add_argument("--corrector", type=str, default=None)
    parser.add_argument("--sampler_n", type=int, default=None,
                        help="bbed reverse-step count override (default 30)")
    parser.add_argument("--corrector_steps", type=int, default=None,
                        help="bbed corrector steps per reverse step (default 1)")
    parser.add_argument("--timestep_type", type=str, default=None,
                        choices=("linear", "bridge_geom", "logit"),
                        help="bbed sampler time-grid override")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where to serve: the card (default) or cpu")
    args = parser.parse_args(argv)
    if (args.ckpt is None) == (args.artifact is None):
        parser.error("exactly one of --ckpt / --artifact is required")
    if args.artifact and (args.snr_ckpt or args.ckpt_step is not None or args.monitor):
        # an artifact holds no estimator and no steps to choose from: ignoring
        # these would serve something else than asked, without a word
        parser.error("--snr_ckpt/--ckpt_step/--monitor apply to --ckpt mode only; an "
                     "artifact is a fixed program (clients pass ?est_snr= for *_snr branches)")

    from ..serving.http import make_server, serve_forever_in_thread

    if args.artifact:
        from ..serving.export import ArtifactService

        service = ArtifactService(args.artifact, seed=args.seed)
        buckets = [b["pad_samples"] for b in service.meta["buckets"]]
        label = (f"artifact {service.meta['branch']}, {service.meta['dtype']} trunk "
                 f"(buckets {buckets})")
    else:
        service = _checkpoint_service(args)
        label = service.model_type
    server = make_server(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"serving {label} on http://{host}:{port} "
          f"(POST /enhance, GET /healthz, GET /stats)", flush=True)
    thread = serve_forever_in_thread(server)
    if not block:
        return server, service, thread
    try:
        thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


def _checkpoint_service(args):
    """The dynamic batcher over the checkpoint's EMA weights."""
    from ..serving.service import EnhanceService, ServiceConfig
    from ..train.restore import load_score_model, load_snr_model
    from ..train.state import load_ema

    snr_net = None
    if args.snr_ckpt:
        snr_model, snr_state = load_snr_model(args.snr_ckpt, device=args.device)
        load_ema(snr_state)
        snr_net = snr_model.dnn
    model, state = load_score_model(args.ckpt, step=args.ckpt_step, monitor=args.monitor,
                                    snr_model=snr_net, device=args.device)
    load_ema(state)

    sampler_kwargs = {
        k: v for k, v in (("predictor", args.predictor), ("corrector", args.corrector),
                          ("N", args.sampler_n), ("timestep_type", args.timestep_type),
                          ("corrector_steps", args.corrector_steps))
        if v is not None
    } or None
    return EnhanceService(model, config=ServiceConfig(
        chunk_frames=args.chunk_frames, overlap_frames=args.overlap_frames,
        batch_size=args.batch_size, max_flight_utts=args.max_flight_utts,
        max_wait_ms=args.max_wait_ms, seed=args.seed, sampler_kwargs=sampler_kwargs))


if __name__ == "__main__":
    main()
