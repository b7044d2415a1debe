"""First-token times of an `n` = 3 request's choices through the port's
HTTP server, against three lone requests sent together and one alone.

    python3 scripts/torch_sibling_ttft.py [--rounds N]
    PYTHONPATH=<another tree> python3 scripts/torch_sibling_ttft.py

Starts the CLI's server (`dynamo_tpu_torch.cli.run.start_server`: llama3-1b
in bf16, random weights from the CLI's seed, prefix caching and the other
knobs at the CLI's defaults) and sends, one round after another, on a
prompt under one page (`short`) and on a fresh prompt of about 1,100
tokens (`long`, new text each round so that its first request misses the
prefix cache):
  - `n3`: one streamed request with n = 3 (chip_smoke's N_CHOICES, its
    three biased ids a quarter of the vocabulary apart): the ms from
    sending it to each choice's first token;
  - `together`: three streamed lone requests with seeds s, s + 1, s + 2,
    sent at once from three threads: each one's first-token ms;
  - `lone`: one streamed lone request.
Round 0 captures the step graphs of every arm; compare rounds from 1 on.
Prints one JSON line a round and prompt, then the card's name and power
limit. The package is imported from PYTHONPATH where it is
set, else from this script's tree, so one copy of the script times two
trees in one call: run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

# after PYTHONPATH's entries: a tree given there is the one timed
sys.path.append(str(Path(__file__).resolve().parent.parent))

#: chip_smoke.serve_sampling's n = 3 request but for its biased ids
#: (`biased`), which fit any model's vocabulary
N_CHOICES = dict(n=3, seed=5, temperature=33.0, top_k=3, max_tokens=6)
SHORT = [{"role": "user", "content": "sampling surface"}]
EXT = {"ignore_eos": True, "return_token_ids": True}
STREAM = {"stream": True, "stream_options": {"include_usage": True}}


def long_prompt(tag: str) -> list[dict]:
    """About 1,100 bytes (one token a byte), apart in its first page from
    another tag's."""
    return [{"role": "user", "content": f"choices {tag}: " + "a long question " * 68}]


def first_tokens(url: str, body: dict) -> dict[int, float]:
    """Streams `body` and returns each choice index's first-token ms."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    first: dict[int, float] = {}
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise RuntimeError(f"{url}: status {resp.status}")
        for raw in resp:
            line = raw.decode().strip()
            if line == "data: [DONE]":
                break
            if not line:
                continue
            for c in json.loads(line[len("data: "):])["choices"]:
                if c.get("token_ids"):
                    first.setdefault(c["index"], (time.perf_counter() - t0) * 1e3)
        else:
            raise RuntimeError(f"{url}: the stream did not end in [DONE]")
    if sorted(first) != list(range(body.get("n", 1))):
        raise RuntimeError(f"{url}: first tokens of choices {sorted(first)} only")
    return first


def biased(vocab: int) -> dict:
    """Three ids a quarter of the vocabulary apart, biased +33, +66, +99."""
    return {str(vocab // 4 * (i + 1)): 33 * (i + 1) for i in range(3)}


def measure(chat: str, model: str, bias: dict, messages, tag: str) -> dict:
    body = {"model": model, "ext": EXT, "logit_bias": bias, **STREAM}
    n3 = first_tokens(chat, {**body, "messages": messages(f"n{tag}"), **N_CHOICES})
    lone = {**N_CHOICES, "n": 1}
    together: list = [None] * 3

    def run(i):
        together[i] = first_tokens(chat, {**body, "messages": messages(f"t{tag}"),
                                          **lone, "seed": N_CHOICES["seed"] + i})[0]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if None in together:
        raise RuntimeError(f"three lone requests together: {together}")
    alone = first_tokens(chat, {**body, "messages": messages(f"l{tag}"), **lone})[0]
    return {"n3_ttft_ms": [n3[i] for i in range(3)], "together_ttft_ms": together,
            "lone_ttft_ms": alone}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4, help="rounds, the first a warm-up")
    ap.add_argument("--model", default="llama3-1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    import dynamo_tpu_torch
    from dynamo_tpu_torch.cli.run import start_server

    server = start_server(["run", "in=http", "out=torch", "--model", args.model, "--port", "0",
                           "--device", args.device, "--dtype", args.dtype])
    try:
        chat = server.url + "/v1/chat/completions"
        bias = biased(server.runner.engine.adapter.vocab_size)
        package = str(Path(dynamo_tpu_torch.__file__).parent)
        for r in range(args.rounds):
            for name, messages in (("short", lambda tag: SHORT), ("long", long_prompt)):
                got = measure(chat, args.model, bias, messages, f"{r}")
                print(json.dumps({"round": r, "prompt": name, "package": package, **got}),
                      flush=True)
    finally:
        server.stop()
    if args.device != "cpu":
        from dynamo_tpu_torch import platform
        print(platform.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
