"""piper-tpu's command line on the port: the HTTP serving mode.

    python -m piper_tpu_torch.cli --serve [--stream] --model a.onnx[,b.onnx] [--prewarm]
    python -m piper_tpu_torch.cli --serve --voice en_GB-northern_english_male-medium

The serve mode of piper_tpu.cli (its `run_serve`, with the same flags, voice
keys, banner and SIGTERM drain) over the port's PiperHTTPServer
(engine/http_server.py): one or more voices behind the continuous batcher,
and with --stream the chunked POST /v1/stream beside it on one device
worker. The runtimes go to `--device`: "cuda" by default, which raises
where there is no card; "cpu" only when asked. The JAX CLI's other modes
(one-shot synthesis, the REPL, the bench and vector modes) are not ported
yet: without --serve the command exits naming the ROADMAP item that brings
them.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions

UNPORTED_MODES = ("the CLI's modes other than --serve (one-shot --text/--ipa/--phoneme-ids/"
                  "--ssml synthesis, the REPL, --list-voices, the bench and test-vector "
                  "modes) are not ported yet: they come with client.py and testing.py "
                  "(ROADMAP §1 item 6)")


def _cli_options(args) -> RuntimeOptions:
    """Env flags (PIPER_TPU_PRECISION/MODE) as base; explicit CLI args win."""
    from dataclasses import replace

    from piper_tpu_torch.engine.runtime import parse_precision_spec

    options = replace(RuntimeOptions.from_env(), seed=args.seed)
    if args.precision is not None:
        options = replace(options, precision=args.precision)
    if args.output_dtype is not None:
        options = replace(options, output_dtype=args.output_dtype)
    if args.flow_precision is not None:
        options = replace(options, flow_precision=parse_precision_spec(args.flow_precision))
    if args.vocoder_precision is not None:
        options = replace(options,
                          vocoder_precision=parse_precision_spec(args.vocoder_precision))
    options.validate()
    return options


def _load_runtime(args) -> PiperRuntime:
    options = _cli_options(args)
    if args.voice:
        return PiperRuntime.load_voice(args.voice, options, device=args.device)
    if args.model:
        return PiperRuntime(args.model, args.config, options, device=args.device)
    raise SystemExit("pass --voice <id> or --model <path> [--config <path>]")


def _install_sigterm_drain(holder: list) -> None:
    """SIGTERM (the `kill`/container-stop signal) drains like Ctrl-C:
    stop accepting, serve everything already admitted, exit 0. Without
    this an orchestrator stop kills admitted requests mid-flight.

    `holder` is filled with the server object once it exists; the handler
    stops its accept loop from a helper thread (BaseServer.shutdown blocks
    until the loop exits, and the loop runs on THIS thread — calling it
    inline would deadlock). Raising out of the handler instead would race:
    a signal landing outside the serve try/except kills the process with
    a traceback."""
    import signal
    import threading

    def _term(signum, frame):
        print("piper-tpu: SIGTERM — draining admitted requests", file=sys.stderr)
        if holder:
            threading.Thread(target=holder[0].httpd.shutdown, daemon=True).start()
        else:
            raise SystemExit(0)  # nothing built yet — nothing to drain

    signal.signal(signal.SIGTERM, _term)


def _drain_and_close(srv) -> None:
    """close() stops the listener and joins the backend worker — every
    admitted request's future resolves before it returns. The short grace
    sleep then lets handler threads (daemonic) finish writing their
    already-resolved responses before the process exits."""
    srv.close()
    time.sleep(0.5)


def run_serve(args) -> None:
    """HTTP serving front-end: one or more voices behind the multi-voice
    continuous batcher (engine/http_server.py). `--model` takes a comma
    list in serve mode (each .onnx pairs with its sibling .onnx.json), so
    one process serves several voices. With --stream, the SAME process
    additionally serves chunked low-latency `POST /v1/stream` for every
    voice — the backend unifies the batcher and the streaming scheduler on
    one device worker (engine/unified.py)."""
    stop_holder: list = []
    _install_sigterm_drain(stop_holder)
    from piper_tpu_torch.engine.http_server import PiperHTTPServer

    if args.model and "," in str(args.model) and args.config:
        raise SystemExit("--config is ambiguous with several --model paths; "
                         "place each voice's config as <model>.onnx.json "
                         "next to its checkpoint")
    runtimes = {}
    if args.model and "," in str(args.model):
        for path in str(args.model).split(","):
            path = path.strip()
            key = Path(path).stem
            if key in runtimes:
                raise SystemExit(
                    f"two --model paths share the voice key {key!r} (the "
                    "file stem); rename one so requests route unambiguously")
            runtimes[key] = PiperRuntime(path, None, _cli_options(args), device=args.device)
    else:
        rt = _load_runtime(args)
        key = (Path(args.model).stem if args.model
               else (args.voice or "default"))
        runtimes[key] = rt
    srv = PiperHTTPServer(runtimes, host=args.host, port=args.port,
                          stream=args.stream,
                          cache_mb=max(0.0, args.cache_mb))
    stop_holder.append(srv)
    if args.prewarm:
        if args.stream:
            stats = srv.prewarm(
                speaker_mix_programs=args.prewarm_speaker_mix,
                stream_kwargs={"speaker_mix": args.prewarm_speaker_mix})
            n = (sum(v["programs"] for v in stats["batch"].values())
                 + sum(v["programs"] for v in stats["stream"].values()))
        else:
            per_voice = srv.prewarm(speaker_mix_programs=args.prewarm_speaker_mix)
            n = sum(v["programs"] for v in per_voice.values())
        print(f"prewarmed {n} serving programs", file=sys.stderr)
    surfaces = "POST /v1/synthesize, /v1/durations" + (
        ", /v1/stream (chunked)" if args.stream else "")
    print(f"serving voice(s) {sorted(runtimes)} on "
          f"http://{srv.host}:{srv.port} ({surfaces})",
          file=sys.stderr, flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        _drain_and_close(srv)


def build_parser() -> argparse.ArgumentParser:
    """The serve flags of piper_tpu.cli's parser, plus --device."""
    p = argparse.ArgumentParser(prog="piper-tpu", description=__doc__.split("\n\n")[0])
    p.add_argument("--voice", help="voice id to download/load (e.g. en_GB-northern_english_male-medium)")
    p.add_argument("--model", help="path to a .onnx checkpoint (a comma list with --serve)")
    p.add_argument("--config", help="path to the .onnx.json config (default: <model>.json)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--precision", default=None,
                   choices=["highest", "high", "default", "bfloat16"],
                   help="matmul precision tier (default: PIPER_TPU_PRECISION or 'highest')")
    p.add_argument("--output-dtype", default=None, choices=["float32", "int16"],
                   help="PCM format the runtime emits (int16 = WAV wire "
                        "format, converted on device; halves the host copy)")
    p.add_argument("--vocoder-precision", default=None,
                   help="vocoder-only tier ('high' is the bench's mixed "
                        "configuration), 'none', or comma-separated "
                        "per-upsample-level tiers")
    p.add_argument("--flow-precision", default=None,
                   help="decode-flow-only tier ('none' = inherit "
                        "--precision); the encoder/duration path always "
                        "stays at --precision")
    p.add_argument("--prewarm", action="store_true",
                   help="run the serving shape grid before serving (each "
                        "shape's first run pays the card's per-shape costs)")
    p.add_argument("--prewarm-speaker-mix", action="store_true",
                   help="with --prewarm on a multi-speaker voice, also "
                        "warm the speaker-BLENDING variants (requests "
                        "carrying speaker_mix run distinct shapes)")
    p.add_argument("--serve", action="store_true",
                   help="serve the loaded voice(s) over HTTP "
                        "(POST /v1/synthesize; see engine/http_server.py)")
    p.add_argument("--stream", action="store_true",
                   help="with --serve: also serve chunked POST /v1/stream "
                        "(one device worker for batch and stream traffic)")
    p.add_argument("--cache-mb", type=float, default=0.0,
                   help="with --serve: response cache budget in MB "
                        "(synthesis is deterministic, so identical "
                        "requests — canned phrases — serve from memory; "
                        "0 disables)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the runtimes run (default: the card; raises "
                        "without one)")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if not args.serve:
        given = f" (given: {' '.join(unknown)})" if unknown else ""
        raise SystemExit(f"piper_tpu_torch.cli serves over HTTP only: pass --serve{given}; "
                         f"{UNPORTED_MODES}")
    if unknown:
        parser.error(f"unrecognized arguments for --serve: {' '.join(unknown)}")
    try:
        run_serve(args)
    except ValueError as e:  # an option value the port does not carry
        raise SystemExit(f"piper-tpu: {e}") from None


if __name__ == "__main__":
    main()
