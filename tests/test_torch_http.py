"""The CLI's HTTP server, in-process, over urllib.

`dynamo_tpu_torch.cli.run.start_server` builds the same server the
command line runs (engine thread + standard-library HTTP server) on an
ephemeral port, here with --device cpu and the tiny model (the kernels'
plain versions serve on CPU tensors). Streaming and unary chat and
completions, /v1/models and /health; usage counts must match the tokens.
The sampling surface: logprobs in the chat and the legacy shapes, n > 1
choices, penalties, logit_bias and the ext knobs, and the 400s the JAX
package answers for their bad values.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from dynamo_tpu_torch.cli.run import start_server
from dynamo_tpu_torch.frontend.service import ModelPipeline
from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
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
    ("/v1/chat/completions", {"model": "tiny", "messages": MESSAGES,
                              "tools": ["get_weather", {"type": "function"}]}, 400),
    ("/v1/chat/completions",
     {"model": "tiny", "messages": MESSAGES, "ext": {"return_token_ids": "yes"}}, 400),
    ("/v1/completions", {"model": "tiny", "prompt": "The sky", "echo": True}, 400),
])
def test_refusals_are_http_statuses(server, path, body, status):
    """The `tools` case is an ill-typed list (a string among the objects),
    which pydantic's Optional[list[dict]] refuses in the JAX package;
    well-formed tools are served (test_tools_are_served). `echo`, which the
    JAX package declares and never reads, is refused by name."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url + path, body)
    assert e.value.code == status
    assert "error" in json.load(e.value)


@pytest.mark.parametrize("tools", [[{"type": "function", "function": {"name": "f"}}], [], None])
def test_tools_are_served(server, tools):
    """A chat with tools is served; the byte tokenizer has no template, so
    they change no prompt token, as in the JAX package. A string is a
    400."""
    body = {"model": "tiny", "messages": MESSAGES, "max_tokens": 2, "tools": tools,
            "ext": {"ignore_eos": True}}
    with _post(server.url + "/v1/chat/completions", body) as r:
        resp = json.load(r)
    assert resp["usage"]["prompt_tokens"] == _prompt_tokens(MESSAGES)
    assert resp["usage"]["completion_tokens"] == 2
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url + "/v1/chat/completions", {**body, "tools": "get_weather"})
    assert e.value.code == 400


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


CHAT = "/v1/chat/completions"


def _entries(events):
    """The logprob entries of a chat stream's chunks, in order."""
    return [e for ev in events for c in ev["choices"]
            for e in (c.get("logprobs") or {}).get("content", [])]


@pytest.mark.parametrize("stream", [False, True])
def test_chat_logprobs_are_served(server, stream):
    """logprobs + top_logprobs 3: one entry per generated token with its
    exact bytes and 3 alternatives, sorted, the greedy token the first of
    them with the same logprob; unary and streamed give the same entries.

    A warm request with the same body goes first, so both compared
    requests hit the prefix cache over the same pages whichever tests ran
    on the module's server before: a cold prefill and a hit's chunk with
    history round the fp32 logprobs differently in the last bits."""
    body = {"model": "tiny", "messages": MESSAGES, "max_tokens": 6, "logprobs": True,
            "top_logprobs": 3, "ext": {"ignore_eos": True}}
    with _post(server.url + CHAT, body) as r:
        json.load(r)
    with _post(server.url + CHAT, body) as r:
        resp = json.load(r)
    entries = resp["choices"][0]["logprobs"]["content"]
    if stream:
        events, done = _stream(server.url + CHAT, {**body, "stream": True})
        assert done
        assert _entries(events) == entries  # greedy: the same tokens
    assert len(entries) == resp["usage"]["completion_tokens"] == 6
    for e in entries:
        assert e["logprob"] <= 1e-6 and len(e["top_logprobs"]) == 3
        assert bytes(e["bytes"]).decode("utf-8", errors="replace") == e["token"]
        alts = [a["logprob"] for a in e["top_logprobs"]]
        assert alts == sorted(alts, reverse=True)
        assert e["top_logprobs"][0]["bytes"] == e["bytes"]
        assert e["top_logprobs"][0]["logprob"] == e["logprob"]


def test_a_partial_utf8_token_keeps_its_bytes_and_its_entry(server):
    """A +100 bias on 0xF0 (a lone UTF-8 lead byte) makes every token one:
    its text never renders, and each entry still comes, with its exact
    byte, on the finish chunk."""
    events, done = _stream(server.url + CHAT, {
        "model": "tiny", "messages": MESSAGES, "max_tokens": 3, "stream": True,
        "logprobs": True, "logit_bias": {"240": 100}, "ext": {"ignore_eos": True}})
    assert done
    entries = _entries(events)
    assert [e["bytes"] for e in entries] == [[0xF0]] * 3
    assert all(e["top_logprobs"] == [] for e in entries)
    assert events[-1]["choices"][0]["finish_reason"] == "length"
    assert events[-1]["choices"][0]["logprobs"]["content"] == entries


@pytest.mark.parametrize("stream", [False, True])
def test_completions_logprobs_take_the_legacy_shape(server, stream):
    """/v1/completions logprobs=2: parallel arrays (tokens, token_logprobs,
    top_logprobs as {token: logprob}, text_offset), one item a token."""
    body = {"model": "tiny", "prompt": "abc", "max_tokens": 4, "logprobs": 2,
            "ext": {"ignore_eos": True}}
    if stream:
        events, done = _stream(server.url + "/v1/completions", {**body, "stream": True})
        assert done and all(e["object"] == "text_completion" for e in events)
        blocks = [c["logprobs"] for e in events for c in e["choices"] if c.get("logprobs")]
        assert not any("delta" in c for e in events for c in e["choices"])
    else:
        with _post(server.url + "/v1/completions", body) as r:
            blocks = [json.load(r)["choices"][0]["logprobs"]]
    assert sum(len(b["tokens"]) for b in blocks) == 4
    offsets = [o for b in blocks for o in b["text_offset"]]
    assert offsets == sorted(offsets) and offsets[0] == 0
    for b in blocks:
        assert set(b) == {"tokens", "token_logprobs", "top_logprobs", "text_offset"}
        assert len(b["tokens"]) == len(b["token_logprobs"]) == len(b["top_logprobs"])
        assert all(1 <= len(d) <= 2 for d in b["top_logprobs"])


@pytest.mark.parametrize("stream", [False, True])
def test_n_choices_are_sibling_requests(server, stream):
    """n=3 with a seed: three choices, indices 0-2 under one id, each the
    stream of a lone request with seed s + i, one folded usage (the
    prompt once, completion tokens summed, the siblings' prompt served
    from the prefix cache)."""
    body = {"model": "tiny", "messages": [{"role": "user", "content": "three choices"}],
            "max_tokens": 5, "n": 3, "seed": 11, "temperature": 0.9,
            "ext": {"ignore_eos": True, "return_token_ids": True}}
    if stream:
        events, done = _stream(server.url + CHAT, {
            **body, "stream": True, "stream_options": {"include_usage": True}})
        assert done and len({e["id"] for e in events}) == 1
        ids = {i: [t for e in events for c in e["choices"] if c["index"] == i
                   for t in c.get("token_ids", [])] for i in range(3)}
        usage = events[-1]["usage"]
        assert sum(e["usage"] is not None for e in events if "usage" in e) == 1
    else:
        with _post(server.url + CHAT, body) as r:
            resp = json.load(r)
        assert [c["index"] for c in resp["choices"]] == [0, 1, 2]
        ids = {c["index"]: c["token_ids"] for c in resp["choices"]}
        usage = resp["usage"]
    n_prompt = _prompt_tokens(body["messages"])
    assert usage["prompt_tokens"] == n_prompt and usage["completion_tokens"] == 15
    assert usage["prompt_tokens_details"]["cached_tokens"] >= (n_prompt - 1) // 4 * 4 - 4
    for i in range(3):
        with _post(server.url + CHAT, {**body, "n": 1, "seed": 11 + i}) as r:
            assert json.load(r)["choices"][0]["token_ids"] == ids[i], i


def test_n_siblings_are_submitted_together_and_stream_as_made():
    """n = 3 over a scripted engine: choices 1 and 2 are submitted together
    once choice 0's first event came (each waits, before its first event,
    until both were submitted), and chunks come as each choice makes them
    (the siblings emit only after the caller has read choice 0's last
    token), with indices 0-2 and one folded usage. The card's page of 4
    tokens makes the 19-token prompt longer than a page, so that the
    siblings can hit choice 0's pages and wait for them."""
    submitted, both, release = [], threading.Barrier(2, timeout=10), threading.Event()

    def engine_fn(pre):
        submitted.append(pre.request_id)
        if pre.request_id.endswith("-0"):
            yield {"token_ids": [65], "finish_reason": None}
            yield {"token_ids": [66], "finish_reason": "length"}
            return
        both.wait()
        assert release.wait(10)
        yield {"token_ids": [67], "finish_reason": "length"}

    pipe = ModelPipeline(ModelDeploymentCard(name="tiny", kv_page_size=4), engine_fn,
                         prefix_caching=True)
    req = ChatCompletionRequest.from_json({
        "model": "tiny", "messages": [{"role": "user", "content": "hi"}], "n": 3,
        "max_tokens": 2, "stream": True, "stream_options": {"include_usage": True},
        "ext": {"return_token_ids": True}})
    got = []
    for chunk in pipe.chat_stream(req):
        got += [(c.index, t) for c in chunk.choices for t in c.token_ids or ()]
        if (0, 66) in got:
            release.set()
    parent = submitted[0].removesuffix("-0")
    assert sorted(submitted[1:]) == [f"{parent}-1", f"{parent}-2"]
    assert got[:2] == [(0, 65), (0, 66)] and sorted(got[2:]) == [(1, 67), (2, 67)]
    assert chunk.usage.completion_tokens == 4 and not chunk.choices


@pytest.mark.parametrize("page,caching", [(64, True), (4, False)])
def test_n_siblings_are_submitted_at_once_where_waiting_saves_no_prefill(page, caching):
    """n = 3 on a 19-token prompt under a page of 64 tokens (no whole page
    before its last to share), and on the same prompt over a page of 4
    with prefix caching off: all three are submitted before any of them
    has its first event (each waits, before its first event, until all
    three were submitted), as the reference's pumps start together."""
    submitted, all_three = [], threading.Barrier(3, timeout=10)

    def engine_fn(pre):
        submitted.append(pre.request_id)
        all_three.wait()
        yield {"token_ids": [65 + int(pre.request_id[-1])], "finish_reason": "length"}

    pipe = ModelPipeline(ModelDeploymentCard(name="tiny", kv_page_size=page), engine_fn,
                         prefix_caching=caching)
    req = ChatCompletionRequest.from_json({
        "model": "tiny", "messages": [{"role": "user", "content": "hi"}], "n": 3,
        "max_tokens": 1, "stream": True, "ext": {"return_token_ids": True}})
    got = sorted((c.index, t) for chunk in pipe.chat_stream(req)
                 for c in chunk.choices for t in c.token_ids or ())
    assert got == [(0, 65), (1, 66), (2, 67)]
    parent = submitted[0][:-2]
    assert sorted(submitted) == [f"{parent}-{i}" for i in range(3)]


def test_penalties_bias_and_ext_knobs_are_served(server):
    """A penalized request, a +100 logit_bias that forces its token, and
    min_tokens with a +100 bias on eos (token 0): exactly min_tokens + 1
    tokens, finishing `stop`; nvext greed_sampling ignores the
    temperature."""
    chat = server.url + CHAT
    with _post(chat, {"model": "tiny", "messages": MESSAGES, "max_tokens": 8,
                      "frequency_penalty": 1.0, "presence_penalty": 0.5,
                      "nvext": {"repetition_penalty": 1.3, "ignore_eos": True}}) as r:
        assert json.load(r)["usage"]["completion_tokens"] == 8
    with _post(chat, {"model": "tiny", "messages": MESSAGES, "max_tokens": 4,
                      "logit_bias": {"90": 100}, "ext": {"ignore_eos": True}}) as r:
        assert json.load(r)["choices"][0]["message"]["content"] == "ZZZZ"
    with _post(chat, {"model": "tiny", "messages": MESSAGES, "max_tokens": 9,
                      "logit_bias": {"0": 100}, "ext": {"min_tokens": 4}}) as r:
        resp = json.load(r)
    assert resp["usage"]["completion_tokens"] == 5
    assert resp["choices"][0]["finish_reason"] == "stop"
    greedy = {"model": "tiny", "messages": MESSAGES, "max_tokens": 5,
              "ext": {"ignore_eos": True, "return_token_ids": True}}
    with _post(chat, greedy) as r:
        want = json.load(r)["choices"][0]["token_ids"]
    for seed in (1, 2):
        with _post(chat, {**greedy, "temperature": 1.5, "seed": seed,
                          "ext": {**greedy["ext"], "greed_sampling": True}}) as r:
            assert json.load(r)["choices"][0]["token_ids"] == want


@pytest.mark.parametrize("path,extra", [
    (CHAT, {"logprobs": True, "top_logprobs": 21}),
    ("/v1/completions", {"logprobs": 6}),
    (CHAT, {"top_logprobs": 3}),
    (CHAT, {"logit_bias": {str(i): 1 for i in range(17)}}),
    (CHAT, {"logit_bias": {"99999": 1}}),
    (CHAT, {"nvext": {"repetition_penalty": 2.5}}),
    (CHAT, {"ext": {"min_tokens": -1}}),
])
def test_sampling_refusals_are_400s(server, path, extra):
    """The JAX package's 400s: top_logprobs over 20, legacy logprobs over
    5, top_logprobs without logprobs, 17 bias slots, a bias id outside the
    vocabulary (refused by the engine at admission), an nvext repetition
    penalty over 2.0 and a negative min_tokens."""
    body = ({"prompt": "x"} if path == "/v1/completions" else {"messages": MESSAGES})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.url + path, {"model": "tiny", "max_tokens": 2, **body, **extra})
    assert e.value.code == 400
    assert "error" in json.load(e.value)
