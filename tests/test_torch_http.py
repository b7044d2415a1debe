"""The CLI's HTTP server, in-process, over urllib.

`dynamo_tpu_torch.cli.run.start_server` builds the same server the
command line runs (engine thread + standard-library HTTP server) on an
ephemeral port, here with --device cpu and the tiny model (the kernels'
plain versions serve on CPU tensors). Streaming and unary chat and
completions, /v1/models and /health; usage counts must match the tokens.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from dynamo_tpu_torch.cli.run import start_server
from dynamo_tpu_torch.preprocessor.tokenizer import ByteTokenizer

ARGS = [
    "run", "in=http", "out=torch", "--model", "tiny", "--port", "0", "--device", "cpu",
    "--dtype", "float32", "--page-size", "4", "--max-context", "128", "--num-pages", "96",
    "--decode-steps", "4", "--prefill-chunk", "64",
]


@pytest.fixture(scope="module")
def server():
    srv = start_server(ARGS)
    yield srv
    srv.stop()


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}
    )
    return urllib.request.urlopen(req, timeout=120)


def _stream(url, body):
    """(data events as dicts, whether the stream ended in [DONE])."""
    with _post(url, body) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "text/event-stream"
        lines = [ln.decode().strip() for ln in resp if ln.strip()]
    assert all(ln.startswith("data: ") for ln in lines)
    payloads = [ln[len("data: "):] for ln in lines]
    done = payloads[-1] == "[DONE]"
    return [json.loads(p) for p in payloads if p != "[DONE]"], done


def _prompt_tokens(messages):
    tok = ByteTokenizer()
    return len(tok.encode(tok.apply_chat_template(messages)))


MESSAGES = [{"role": "user", "content": "hello there"}]


def test_health_and_models(server):
    with urllib.request.urlopen(server.url + "/health", timeout=30) as r:
        assert json.load(r) == {"status": "ok", "models": ["tiny"]}
    with urllib.request.urlopen(server.url + "/v1/models", timeout=30) as r:
        listing = json.load(r)
    assert listing["object"] == "list"
    assert [m["id"] for m in listing["data"]] == ["tiny"]


def test_streaming_chat_counts_its_tokens(server):
    events, done = _stream(server.url + "/v1/chat/completions", {
        "model": "tiny", "messages": MESSAGES, "stream": True, "max_tokens": 7,
        "stream_options": {"include_usage": True}, "ext": {"ignore_eos": True},
    })
    assert done
    assert all(e["object"] == "chat.completion.chunk" for e in events)
    usage = events[-1]["usage"]
    assert events[-1]["choices"] == []
    assert events[-2]["choices"][0]["finish_reason"] == "length"
    assert usage == {"prompt_tokens": _prompt_tokens(MESSAGES), "completion_tokens": 7,
                     "total_tokens": _prompt_tokens(MESSAGES) + 7}


def test_unary_chat_matches_the_stream(server):
    body = {"model": "tiny", "messages": MESSAGES, "max_tokens": 6,
            "ext": {"ignore_eos": True}}
    with _post(server.url + "/v1/chat/completions", body) as r:
        resp = json.load(r)
    assert resp["object"] == "chat.completion"
    assert resp["usage"]["completion_tokens"] == 6
    assert resp["usage"]["prompt_tokens"] == _prompt_tokens(MESSAGES)
    assert resp["choices"][0]["finish_reason"] == "length"
    events, _ = _stream(server.url + "/v1/chat/completions", {**body, "stream": True})
    streamed = "".join(
        c["delta"].get("content") or "" for e in events for c in e["choices"]
    )
    assert resp["choices"][0]["message"]["content"] == streamed  # greedy: same text


def test_completions_unary_and_streaming(server):
    body = {"model": "tiny", "prompt": "The sky is", "max_tokens": 5,
            "ext": {"ignore_eos": True}}
    with _post(server.url + "/v1/completions", body) as r:
        resp = json.load(r)
    assert resp["object"] == "text_completion"
    assert resp["usage"] == {"prompt_tokens": len(b"The sky is"), "completion_tokens": 5,
                             "total_tokens": len(b"The sky is") + 5}
    events, done = _stream(server.url + "/v1/completions", {**body, "stream": True})
    assert done and all(e["object"] == "text_completion" for e in events)
    assert "".join(c["text"] for e in events for c in e["choices"]) == resp["choices"][0]["text"]


def test_concurrent_streams_all_finish(server):
    results = {}

    def run(i):
        results[i] = _stream(server.url + "/v1/chat/completions", {
            "model": "tiny", "stream": True, "max_tokens": 4 + i,
            "messages": [{"role": "user", "content": f"request {i}"}],
            "stream_options": {"include_usage": True}, "ext": {"ignore_eos": True},
        })

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(results) == [0, 1, 2, 3]
    for i, (events, done) in results.items():
        assert done and events[-1]["usage"]["completion_tokens"] == 4 + i


def test_token_ids_cover_the_usage(server):
    """ext.return_token_ids: the ids in the chunks are the tokens usage
    counts, one chunk per engine event, the same in a unary response."""
    body = {"model": "tiny", "messages": MESSAGES, "max_tokens": 9,
            "ext": {"ignore_eos": True, "return_token_ids": True}}
    events, done = _stream(server.url + "/v1/chat/completions", {
        **body, "stream": True, "stream_options": {"include_usage": True}})
    assert done
    streamed = [t for e in events for c in e["choices"] for t in c.get("token_ids", [])]
    assert len(streamed) == events[-1]["usage"]["completion_tokens"] == 9
    assert "token_ids" in events[0]["choices"][0]  # the first chunk carries a token
    assert events[0]["choices"][0]["delta"]["role"] == "assistant"
    with _post(server.url + "/v1/chat/completions", body) as r:
        resp = json.load(r)
    assert resp["choices"][0]["token_ids"] == streamed  # greedy: same tokens
    legacy, _ = _stream(server.url + "/v1/completions", {
        "model": "tiny", "prompt": "The sky is", "max_tokens": 5, "stream": True,
        "ext": {"ignore_eos": True, "return_token_ids": True}})
    assert sum(len(c.get("token_ids", [])) for e in legacy for c in e["choices"]) == 5
    # without the extension no choice carries ids
    plain, _ = _stream(server.url + "/v1/chat/completions", {**body, "ext": {"ignore_eos": True},
                                                             "stream": True})
    assert not any("token_ids" in c for e in plain for c in e["choices"])


@pytest.mark.parametrize("path,body,status", [
    ("/v1/chat/completions", {"model": "tiny"}, 400),
    ("/v1/chat/completions", {"model": "nope", "messages": MESSAGES}, 404),
    ("/v1/chat/completions", {"model": "tiny", "messages": MESSAGES, "logprobs": True}, 400),
    ("/v1/chat/completions",
     {"model": "tiny", "messages": MESSAGES, "ext": {"return_token_ids": "yes"}}, 400),
])
def test_refusals_are_http_statuses(server, path, body, status):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url + path, body)
    assert e.value.code == status
    assert "error" in json.load(e.value)


@pytest.mark.parametrize("stream", [False, True])
def test_prompt_longer_than_one_chunk_is_served(server, stream):
    """A 100-token prompt (the server's chunk is 64 tokens) prefills in two
    chunks and is served, unary and streaming; usage counts its tokens."""
    body = {"model": "tiny", "prompt": "x" * 100, "max_tokens": 5,
            "ext": {"ignore_eos": True, "return_token_ids": True}}
    if stream:
        events, done = _stream(server.url + "/v1/completions",
                               {**body, "stream": True, "stream_options": {"include_usage": True}})
        assert done
    else:
        with _post(server.url + "/v1/completions", body) as resp:
            assert resp.status == 200
            events = [json.load(resp)]
    usage = events[-1]["usage"]
    ids = [t for e in events for c in e["choices"] for t in c.get("token_ids", [])]
    assert usage["prompt_tokens"] == len(ByteTokenizer().encode("x" * 100)) >= 100
    assert usage["completion_tokens"] == len(ids) == 5


@pytest.mark.parametrize("extra,chunk", [
    ([], 512),                                  # the JAX CLI's default
    (["--prefill-chunk", "128"], 128),
    (["--prefill-chunk", "96"], None),          # not a multiple of the page size
    (["--max-context", "256"], None),           # the default chunk exceeds the context
    (["--max-context", "256", "--prefill-chunk", "256"], 256),
])
def test_prefill_chunk_defaults_to_512_and_is_validated(extra, chunk):
    from dynamo_tpu_torch.cli.run import _parse

    argv = ["run", "in=http", "out=torch", *extra]
    if chunk is None:
        with pytest.raises(SystemExit, match="--prefill-chunk"):
            _parse(argv)
    else:
        assert _parse(argv).prefill_chunk == chunk


def test_kv_quantize_int8_server_serves_a_streaming_chat():
    """The CLI with --kv-quantize int8 (on the CPU) serves a streaming chat
    whose prompt prefills in two chunks over the int8 pool: usage counts
    its tokens, and every write and history read took the int8 variant."""
    from dynamo_tpu_torch import ops

    srv = start_server(ARGS + ["--kv-quantize", "int8"])
    try:
        assert srv.runner.engine.kv.k.dtype == torch.int8 and srv.runner.engine.kv.quantized
        ops.reset_counts()
        messages = [{"role": "user", "content": "a longer prompt " * 5}]
        events, done = _stream(srv.url + "/v1/chat/completions", {
            "model": "tiny", "messages": messages, "max_tokens": 6, "stream": True,
            "stream_options": {"include_usage": True},
            "ext": {"ignore_eos": True, "return_token_ids": True},
        })
    finally:
        srv.stop()
    assert done
    ids = [t for e in events for c in e["choices"] for t in c.get("token_ids", [])]
    usage = events[-1]["usage"]
    assert usage["completion_tokens"] == len(ids) == 6
    assert usage["prompt_tokens"] == _prompt_tokens(messages) > 64
    for name in ("paged_write", "paged_decode_attention", "paged_prefill_attention"):
        assert ops.COUNTS[f"{name}.int8"].plain_calls > 0
        assert ops.COUNTS[name].plain_calls == 0


@pytest.mark.parametrize("flag,mode", [
    ([], None), (["--kv-quantize", "int8"], "int8"), (["--kv-quantize", "fp8"], "fp8"),
    (["--kv-quantize", "int4"], "refused"),
])
def test_kv_quantize_flag_reaches_the_engine_config(flag, mode):
    from dynamo_tpu_torch.cli.run import _parse, engine_config

    argv = ["run", "in=http", "out=torch", *flag]
    if mode == "refused":
        with pytest.raises(SystemExit):
            _parse(argv)
    else:
        assert engine_config(_parse(argv), ()).kv_quantize == mode


def test_a_shared_system_message_is_served_from_the_prefix_cache(server):
    """Two chats that share a system message, one after the other, the first
    streamed and the second unary (the CLI serves with prefix caching on,
    and has no switch for it): the first has no prompt_tokens_details; the
    second's cached_tokens are the whole pages (4 tokens each) of the
    prompts' common prefix, at most all but the last page of its prompt.
    (No other test of this server sends a system message, whose first
    bytes every such prompt shares.)"""
    system = {"role": "system", "content": "answer briefly, politely and in plain words."}
    pair = [[system, {"role": "user", "content": q}] for q in ("first?", "and a second?")]
    body = {"model": "tiny", "messages": pair[0], "max_tokens": 3, "stream": True,
            "stream_options": {"include_usage": True}, "ext": {"ignore_eos": True}}
    events, done = _stream(server.url + "/v1/chat/completions", body)
    assert done
    first = events[-1]["usage"]
    with _post(server.url + "/v1/chat/completions",
               {**body, "messages": pair[1], "stream": False}) as r:
        second = json.load(r)["usage"]
    tok = ByteTokenizer()
    a, b = (tok.encode(tok.apply_chat_template(m)) for m in pair)
    common = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    want = min(common // 4, (len(b) - 1) // 4) * 4
    assert "prompt_tokens_details" not in first
    assert second["prompt_tokens_details"] == {"cached_tokens": want}
    assert want >= 48 and second["prompt_tokens"] == len(b)
