"""`run` — serve a model over the OpenAI HTTP API on one GPU.

    python -m dynamo_tpu_torch.cli.run run in=http out=torch --model llama3-1b --port 8080
    python -m dynamo_tpu_torch.cli.run run in=http out=torch --model <hf dir | file.gguf>

Counterpart of dynamo_tpu/cli/run.py for the `in=http out=<engine>` shape,
with the TorchEngine as the engine. `--model` is a preset, a local HF
checkpoint directory (config.json with safetensors, sharded or not, or
pytorch_model.bin) or a .gguf file; a directory or file serves its own
weights, a preset with `--checkpoint DIR` that directory's, and with
neither the model is random-init from a fixed seed. The card is built as
the JAX CLI's `_card` builds it: `--tokenizer DIR` serves that HF
tokenizer; a .gguf file with a vocabulary serves it, with its EOS id, and
caps the context at the file's; a directory with tokenizer_config.json
serves its tokenizer; otherwise the byte tokenizer. A prompt prefills in page-aligned chunks of `--prefill-chunk`
tokens (512 by default, as the JAX CLI's). `--quantize int8` stores the
layers' dense weights as int8 with per-output-channel scales, and
`--kv-quantize int8|fp8` the KV pages quantized, as the JAX CLI's flags
do; the two combine. Decode runs
the overlapped loop unless `--no-overlap-decode` is given, as in the JAX
CLI. While prompts prefill beside running decodes, each step carries both
(mixed steps) unless `--no-mixed-steps` is given, as in the JAX CLI.
Prefix caching is on, as in the JAX CLI, which has no flag for it
either. `--spec-ngram S` verifies S prompt-lookup drafts a greedy decode
step in one forward, as the JAX CLI's flag does (it turns the overlapped
loop, mixed steps and K-step windows off). `--spec-draft NAME` drafts
`--spec-draft-tokens` tokens (4) a decode step with a small model of the
target's vocabulary (`llama3-draft` for the llama3 presets; the target's
own name shares its weights) and verifies and accepts them on the device,
beside the overlapped loop and mixed steps, as the JAX CLI's flags do;
`--spec-draft-checkpoint` loads the draft's weights from an HF directory
or a .gguf file. It runs on the GPU unless `--device cpu` is given.

`start_server(argv)` builds and starts the same server in-process and
returns it; `main` blocks serving until interrupted.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch import gguf
from dynamo_tpu_torch.engine.async_engine import AsyncEngineRunner
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.frontend.http import HttpService
from dynamo_tpu_torch.frontend.service import ModelManager, local_pipeline
from dynamo_tpu_torch.model_card import ModelDeploymentCard

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dynamo_tpu_torch.cli.run")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="serve a model")
    runp.add_argument("io", nargs="*", help="in=http out=torch")
    runp.add_argument("--model", default="tiny",
                      help="a preset, a local HF checkpoint directory or a .gguf file")
    runp.add_argument("--checkpoint", default=None, help="local HF checkpoint dir")
    runp.add_argument("--tokenizer", default=None, help="local tokenizer dir")
    runp.add_argument("--host", default="127.0.0.1")
    runp.add_argument("--port", type=int, default=8080, help="0 picks a free port")
    runp.add_argument("--num-pages", type=int, default=512, dest="num_pages")
    runp.add_argument("--page-size", type=int, default=64, dest="page_size")
    runp.add_argument("--max-context", type=int, default=4096, dest="max_context")
    runp.add_argument(
        "--prefill-chunk", type=int, default=512, dest="prefill_chunk",
        help="most prompt tokens of one request prefilled per step (a multiple "
             "of --page-size, at most --max-context)",
    )
    runp.add_argument("--decode-steps", type=int, default=8, dest="decode_steps",
                      help="decode steps fused per host sync")
    runp.add_argument(
        "--decode-kstep", type=int, default=1, dest="decode_kstep",
        help="run K decode iterations in one captured step function per dispatch, with "
             "stop ids and budgets judged on the device (a finished row freezes "
             "mid-window); 1 (default) = off. Rows asking for logprobs fall back",
    )
    runp.add_argument(
        "--no-overlap-decode", action="store_false", dest="overlap_decode", default=True,
        help="disable the overlapped decode loop (speculative next-step dispatch with "
             "one-step-lagged host readback; on by default)",
    )
    runp.add_argument(
        "--no-mixed-steps", action="store_false", dest="mixed_steps", default=True,
        help="disable mixed prefill+decode steps (one dispatch carrying a bounded prefill "
             "chunk plus the decode batch, so decodes emit a token every step while a "
             "prompt burst drains; on by default)",
    )
    runp.add_argument(
        "--spec-ngram", type=int, default=0, dest="spec_ngram",
        help="speculative decoding: draft tokens per step proposed by prompt lookup and "
             "verified in one forward pass (0 = off)",
    )
    runp.add_argument(
        "--spec-draft", default=None, dest="spec_draft",
        help="draft-model speculative decoding: a small model of the target's vocabulary "
             "(llama3-draft for the llama3 presets) proposes greedy drafts that are verified "
             "and accepted on the device each decode step; greedy output is unchanged and "
             "sampled output keeps its distribution. Composes with the overlapped loop and "
             "mixed steps (unlike --spec-ngram)",
    )
    runp.add_argument(
        "--spec-draft-tokens", type=int, default=4, dest="spec_draft_tokens",
        help="drafts proposed and verified per step with --spec-draft (default 4)",
    )
    runp.add_argument(
        "--spec-draft-checkpoint", default=None, dest="spec_draft_checkpoint",
        help="the draft's weights: a local HF checkpoint directory or a .gguf file",
    )
    runp.add_argument("--max-seqs", type=int, default=32, dest="max_seqs")
    runp.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    runp.add_argument(
        "--quantize", default=None, choices=("int8",),
        help="weight-only quantization (per-output-channel int8 scales)",
    )
    runp.add_argument(
        "--kv-quantize", default=None, choices=("int8", "fp8"), dest="kv_quantize",
        help="KV-cache page quantization: pages store int8 (or fp8) rows with "
             "per-token f32 scales, about twice the tokens in the same memory",
    )
    runp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def _parse(argv) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    io = dict(kv.split("=", 1) for kv in args.io if "=" in kv)
    if io.get("in", "http") != "http" or io.get("out", "torch") != "torch":
        raise SystemExit("dynamo_tpu_torch serves in=http out=torch only")
    if args.max_context % args.page_size:
        raise SystemExit("--max-context must be a multiple of --page-size")
    if args.prefill_chunk % args.page_size or not 0 < args.prefill_chunk <= args.max_context:
        raise SystemExit(
            "--prefill-chunk must be a multiple of --page-size and at most --max-context"
        )
    return args


def model_card(args) -> ModelDeploymentCard:
    """The card the JAX CLI's `_card` builds: the tokenizer, the context
    length and the EOS ids from --tokenizer, a .gguf model's vocabulary and
    limits, or a checkpoint directory's tokenizer."""
    tokenizer = {"kind": "byte"}
    context_length = args.max_context
    eos: tuple[int, ...] = ()
    if args.tokenizer:
        tokenizer = {"kind": "hf", "path": args.tokenizer}
    elif args.model.endswith(".gguf") and os.path.isfile(args.model):
        g = gguf.read_gguf(args.model)
        vocab = g.tokenizer_vocab()
        if vocab is not None:
            tokenizer = {"kind": "gguf", "path": args.model}
            if vocab.get("eos_token_id") is not None:
                eos = (int(vocab["eos_token_id"]),)
        context_length = min(context_length, g.context_length())
    elif os.path.isdir(args.model) and os.path.exists(
            os.path.join(args.model, "tokenizer_config.json")):
        tokenizer = {"kind": "hf", "path": args.model}
    return ModelDeploymentCard(
        name=args.model, tokenizer=tokenizer, context_length=context_length,
        kv_page_size=args.page_size, **({"eos_token_ids": eos} if eos else {}),
    )


def engine_config(args, eos_token_ids: tuple[int, ...]) -> EngineConfig:
    return EngineConfig(
        model=args.model,
        num_pages=args.num_pages,
        page_size=args.page_size,
        max_pages_per_seq=args.max_context // args.page_size,
        prefill_chunk=args.prefill_chunk,
        max_seqs=args.max_seqs,
        decode_steps=args.decode_steps,
        decode_kstep=args.decode_kstep,
        overlap_decode=args.overlap_decode,
        mixed_steps=args.mixed_steps,
        spec_ngram=args.spec_ngram,
        spec_draft_model=args.spec_draft,
        spec_draft_tokens=args.spec_draft_tokens,
        spec_draft_checkpoint=args.spec_draft_checkpoint,
        dtype=args.dtype,
        quantize=args.quantize,
        kv_quantize=args.kv_quantize,
        eos_token_ids=eos_token_ids,
    )


@dataclass
class Server:
    """A started HTTP server with its engine thread."""

    service: HttpService
    runner: AsyncEngineRunner

    @property
    def url(self) -> str:
        return f"http://{self.service.host}:{self.service.port}"

    def stop(self) -> None:
        self.service.stop()
        self.runner.stop()


def start_server(argv) -> Server:
    """Build the engine, its thread and the HTTP server from CLI args, and
    start them; returns once the server is listening."""
    args = _parse(argv)
    card = model_card(args)
    engine = TorchEngine(engine_config(args, card.eos_token_ids), device=args.device,
                         checkpoint_path=args.checkpoint)
    runner = AsyncEngineRunner(engine)
    runner.start()
    manager = ModelManager()
    manager.add(args.model, local_pipeline(card, runner))
    service = HttpService(manager, host=args.host, port=args.port)
    service.start()
    return Server(service, runner)


def main(argv: Optional[list[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    server = start_server(sys.argv[1:] if argv is None else argv)
    print(f"listening on {server.url}/v1", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
