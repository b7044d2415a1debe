"""The port's chat templates against transformers' and the JAX package's.

`dynamo_tpu_torch.preprocessor.chat_template` renders a tokenizer's
chat_template with the standard library; the reference is transformers'
environment (`_compile_jinja_template`: jinja2's ImmutableSandboxedEnvironment
with trim_blocks, lstrip_blocks, loopcontrols, its own tojson and globals)
and the JAX package's `HfTokenizer.apply_chat_template` on the same
directories:
- one case per construct of the subset, each rendered by both;
- each served family's template (the transcriptions in chip_smoke.py, by
  Hub repo id) over a corpus of conversations with and without two
  OpenAI tools, and a hypothesis property over random conversations: the
  string and the ids equal the reference's;
- what jinja2 fails on (Gemma with a system message or turns that do not
  alternate, an attribute of an undefined value, a mutating method, a
  filter jinja2 lacks) gives the reference's structured fallback; what
  jinja2 has and the subset lacks is refused by name, a 501 over HTTP;
- template precedence (chat_template.jinja and additional_chat_templates/
  over tokenizer_config.json, named templates, "tool_use" with tools), the
  special tokens in the context, ext.use_raw_prompt, and chip_smoke's
  committed digest of its templated chat;
- the slice as a whole: a templated chat with tools through the port's
  CLI server on a tiny checkpoint directory gives the prompt tokens and
  greedy ids of the JAX engine on the ids the reference's preprocessor
  makes of the same body.
"""

import hashlib
import json
import os
import shutil
import urllib.error
import urllib.request
from datetime import datetime

import jinja2
import jinja2.filters
import jinja2.tests
import pytest
import torch
import transformers
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from transformers import PreTrainedTokenizerFast
from transformers.utils import chat_template_utils

import chip_smoke
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu.preprocessor.preprocessor import OpenAIPreprocessor as JaxPreprocessor
from dynamo_tpu.preprocessor.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.preprocessor.tokenizer import HfTokenizer as JaxHfTokenizer
from dynamo_tpu.protocols.openai import ChatCompletionRequest as JaxChatRequest
from dynamo_tpu_torch.cli.run import start_server
from dynamo_tpu_torch.preprocessor import chat_template
from dynamo_tpu_torch.preprocessor.chat_template import ChatTemplate
from dynamo_tpu_torch.preprocessor.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.preprocessor.tokenizer import (
    ByteTokenizer,
    HfTokenizer,
    render_fallback_template,
)
from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest
from tests.test_torch_kstep import _drive
from tests.test_torch_tokenizer import EOT, EXTRA, KINDS, _build, tokenizer_dirs  # noqa: F401

TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "description": "The weather — now, in °C",
        "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                       "required": ["city"]}}},
    {"type": "function", "function": {
        "name": "add", "description": "Add two numbers",
        "parameters": {"type": "object", "properties": {"a": {"type": "number"},
                                                        "b": {"type": "number"}}}}},
]
_TURNS = ["user", "assistant"]
CORPUS = {
    "one_turn": [{"role": "user", "content": "Hello there"}],
    "system": [{"role": "system", "content": "  Be brief.  "},
               {"role": "user", "content": "What is a page?"}],
    "eight_turns": [{"role": _TURNS[i % 2], "content": f"turn {i}: the kernel, the page."}
                    for i in range(8)],
    "system_eight_turns": [{"role": "system", "content": "You serve models."}] + [
        {"role": _TURNS[i % 2], "content": f"turn {i}\nwith a newline "} for i in range(8)],
    "tool_messages": [
        {"role": "user", "content": "Weather in Paris?"},
        {"role": "assistant", "content": "",
         "tool_calls": [{"type": "function",
                         "function": {"name": "get_weather", "arguments": {"city": "Paris"}}}]},
        {"role": "tool", "content": "{\"temp\": 21}"},
        {"role": "tool", "content": "{\"wind\": 3}"},
        {"role": "user", "content": "Thanks"}],
    "ipython": [{"role": "system", "content": "Tools run in ipython."},
                {"role": "user", "content": "2+2?"}, {"role": "ipython", "content": "4"}],
    "content_list": [{"role": "user", "content": [{"type": "text", "text": "Look: "},
                                                  {"type": "text", "text": "two parts"}]},
                     {"role": "assistant", "content": "Seen."},
                     {"role": "user", "content": "And now?"}],
    "named": [{"role": "user", "content": "Hi, I am Ada", "name": "ada"},
              {"role": "assistant", "content": "Hello Ada", "name": "bot"},
              {"role": "user", "content": "Bye", "name": "ada"}],
    "unicode": [{"role": "system", "content": "Réponds en français ☃"},
                {"role": "user", "content": "日本語のテキスト 😀🎉 ½²Ⅻ café́ {{ not a tag }}"}],
    "thinking": [{"role": "user", "content": "Think first."},
                 {"role": "assistant", "content": "<think>\nso...\n</think>\n\nDone."},
                 {"role": "user", "content": "Again?"}],
}


class _PinnedClock(datetime):
    """datetime.now() at a fixed instant, for strftime_now on both sides."""

    @classmethod
    def now(cls, tz=None):
        return cls(2024, 7, 26, 12, 0, 0)


@pytest.fixture(autouse=True)
def _pinned_clocks(monkeypatch):
    monkeypatch.setattr(chat_template, "datetime", _PinnedClock)
    monkeypatch.setattr(chat_template_utils, "datetime", _PinnedClock)


def _reference(source: str, **context):
    """transformers' render of a template string: ("ok", text) or ("error",
    the exception's type)."""
    try:
        return "ok", chat_template_utils._compile_jinja_template(source).render(**context)
    except Exception as e:
        return "error", type(e).__name__


def _port(source: str, **context):
    try:
        return "ok", ChatTemplate(source).render(**context)
    except NotImplementedError:
        raise
    except Exception as e:
        return "error", type(e).__name__


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    """The byte-level BPE tokenizer of tests/test_torch_tokenizer.py
    (`llama3`), saved by transformers with a bos token, no template."""
    t, extra = _build("llama3")
    fast = PreTrainedTokenizerFast(tokenizer_object=t, eos_token=EOT, bos_token="<|begin|>",
                                   additional_special_tokens=[EXTRA], **extra)
    d = str(tmp_path_factory.mktemp("base"))
    fast.save_pretrained(d)
    return d


def _templated(base: str, dest: str, template=None, jinja=None, extra=None) -> str:
    """A copy of `base` with `template` as tokenizer_config.json's
    chat_template, `jinja` as chat_template.jinja and `extra` as
    additional_chat_templates/<name>.jinja."""
    shutil.copytree(base, dest)
    path = os.path.join(dest, "tokenizer_config.json")
    with open(path, encoding="utf-8") as f:
        config = json.load(f)
    if template is not None:
        config["chat_template"] = template
    with open(path, "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False)
    if jinja is not None:
        with open(os.path.join(dest, "chat_template.jinja"), "w", encoding="utf-8") as f:
            f.write(jinja)
    for name, text in (extra or {}).items():
        os.makedirs(os.path.join(dest, "additional_chat_templates"), exist_ok=True)
        with open(os.path.join(dest, "additional_chat_templates", f"{name}.jinja"), "w",
                  encoding="utf-8") as f:
            f.write(text)
    return dest


@pytest.fixture(scope="module")
def family_dirs(base_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    return {repo: _templated(base_dir, str(root / repo.replace("/", "__")), template=source)
            for repo, source in chip_smoke.CHAT_TEMPLATES.items()}


# -- constructs -----------------------------------------------------------------------

_CONTEXT = dict(messages=[{"role": "user", "content": " a "}, {"role": "assistant",
                                                              "content": "b"}],
                xs=[1, 2, 3], d={"items": 5, "k": "v"}, s="Hello World", n=None, t=True, f=1.5)
CONSTRUCTS = {
    "whitespace_trim_and_lstrip": "  {% if t %}\n    yes\n  {% endif %}\n  after\n",
    "whitespace_minus": "{%- if t -%}\n  yes  \n{%- endif -%}\n x  {{- ' v ' -}}  y",
    "whitespace_plus": "a\n  {%+ if t %}x{% endif +%}\nb",
    "whitespace_variables_untrimmed": "  {{ 1 }}\n  {{ 2 }}\n\n",
    "trailing_newline_and_crlf": "line\r\nnext\rthird\n",
    "comments": "{# c #}a{#- c -#}  b {#+ c +#}  c\n  {# own line #}\n  d",
    "raw": "{% raw %}{{ x }}{% endraw %}|  {%- raw -%}  {% a %}  {%- endraw %}x",
    "if_elif_else": "{% if n %}a{% elif t %}b{% else %}c{% endif %}{% if n %}a{% else %}c{% endif %}",
    "for_tuple_filter_else": "{% for k, v in d.items() %}{{ k }}={{ v }};{% endfor %}"
                             "{% for x in xs if x % 2 %}{{ x }}{% endfor %}"
                             "{% for x in [] %}a{% else %}empty{% endfor %}",
    "break_continue": "{% for x in xs %}{% if x == 1 %}{% continue %}{% endif %}{{ x }}"
                      "{% if x == 2 %}{% break %}{% endif %}{% endfor %}",
    # jinja2 clears its for-else flag at the end of the body only
    "for_else_after_continue_and_break": "{% for x in xs %}{% continue %}{% else %}E{% endfor %}"
                                         "{% for x in xs %}{% break %}{% else %}F{% endfor %}"
                                         "{% for x in xs %}{{ x }}{% else %}never{% endfor %}",
    # what jinja2's compiler folds: a literal's slice through the sandbox,
    # short-circuited operands never compiled, a negative constant base
    "constant_folding": "{{ none[1:] }}|{{ false == true[::-1] }}|{{ false and x|nofilter }}"
                        "|{{ -2 ** (xs|length - 1) }}|{{ [1, 2][::-1] }}",
    "set_and_tuple_set": "{% set a, b = 1, 2 %}{% set (c, e) = [3, 4] %}{{ a }}{{ b }}{{ c }}{{ e }}",
    "namespace_set": "{% set ns = namespace(a=1) %}{% for x in xs %}{% set ns.a = ns.a + x %}"
                     "{% endfor %}{{ ns.a }}{{ ns['a'] }}{{ ns.b }}",
    "block_set_with_filters": "{% set x | trim | length %}  abc{{ 1 }}  {% endset %}{{ x }}"
                              "{% set y | trim %} a {% endset %}[{{ y }}]",
    "for_scope_does_not_leak": "{% set c = 0 %}{% for x in xs %}{% set c = c + 1 %}{{ c }}"
                               "{% set q = 1 %}{% endfor %}|{{ c }}|{{ q }}",
    "if_opens_no_scope": "{% if t %}{% set z = 1 %}{% endif %}{{ z }}",
    "generation": "{% generation %}gen{{ 1 }}{% set g = 1 %}{% endgeneration %}{{ g }}",
    "literals": "{{ none }} {{ true }} {{ False }} {{ [1,'a'] }} {{ {'a': None} }} {{ (1,) }}"
                " {{ 1.0 }} {{ 1e3 }} {{ 0x1F }} {{ 1_000 }} {{ 'a' 'b' }} {{ \"x\\ty\\n\" }}",
    "attribute_then_item": "{{ d.items()|length }}{{ d['items'] }}{{ d.k }}{{ d.get('k') }}"
                           "{{ messages[0].role }}{{ xs.0 }}",
    "subscripts_and_slices": "{{ xs[1:] }}{{ xs[:-1] }}{{ xs[::2] }}{{ xs[::-1] }}{{ s[1:3] }}"
                             "{{ s[-1] }}{{ messages[5] }}",
    "calls_positional_keyword": "{{ s.replace('l', 'L', 1) }}{{ s.split(' ', maxsplit=1) }}"
                                "{{ namespace(a=1, b=n).b }}{{ d.get('k', 0) }}",
    "filter_binds_tighter_than_plus": "{{ '<' + messages[0]['content'] | trim + '>' }}",
    "tests": "{{ x is defined }}{{ n is none }}{{ s is string }}{{ d is mapping }}"
             "{{ xs is iterable }}{{ xs is sequence }}{{ f is number }}{{ t is boolean }}"
             "{{ t is true }}{{ n is false }}{{ xs is not string }}{{ u is undefined }}"
             "{{ 1 is equalto 1 }}{{ xs is not mapping }}",
    "in_and_logic_and_compare": "{{ 1 in xs }}{{ 4 not in xs }}{{ 'He' in s }}{{ t and 'y' }}"
                                "{{ n or 'z' }}{{ not n }}{{ 1 < 2 < 3 }}{{ 1 < 3 < 2 }}"
                                "{{ 1 == 1.0 }}{{ 'a' != 'b' }}",
    "arithmetic": "{{ 1/2 }} {{ 7//2 }} {{ 7 % 3 }} {{ 1 ~ 2 ~ n }} {{ 2**3**2 }} "
                  "{{ -1 + 2 * 3 }} {{ -2|tojson }} {{ 'a' * 3 }} {{ 'a%sb' % 1 }}",
    "conditional_expression": "{{ 1 if t else 2 }}|{{ x if n }}|{{ (x if n) is defined }}"
                              "|{{ 'a' if n else 'b' if t else 'c' }}",
    "str_repr_of_values": "{{ none }}{{ xs }}{{ d }}{{ messages }}{{ (1, 'b') }}",
    "loop_variables": "{% for x in xs %}{{ loop.index }}{{ loop.index0 }}{{ loop.revindex }}"
                      "{{ loop.revindex0 }}{{ loop.first }}{{ loop.last }}{{ loop.length }}"
                      "{{ loop.previtem }}{{ loop.nextitem }};{% endfor %}",
    "nested_loops": "{% for x in [1, 2] %}{{ loop.index }}{% for y in [3] %}{{ loop.index }}"
                    "{{ x }}{% endfor %}{% endfor %}",
    "undefined": "[{{ u }}][{{ u | length }}][{{ 'a' in u }}][{{ u == u }}][{{ u ~ 'x' }}]"
                 "[{% for x in u %}{{ x }}{% endfor %}][{% for k in u|items %}{{ k }}{% endfor %}]"
                 "[{{ u is iterable }}][{{ d.nope }}][{{ messages[9] }}]",
    "sandbox_prints_unsafe_as_empty": "[{{ xs.append }}][{{ d._x }}][{{ xs.__class__ }}][{{ d.pop }}]",
    "str_methods": "{{ 'a,b'.split(',') }}{{ s.startswith('He') }}{{ s.endswith('x') }}"
                   "{{ s.lower() }}{{ s.rstrip('d') }}{{ '\n x '.lstrip('\n') }}{{ s.strip('H') }}"
                   "{{ s.split()[-1] }}{{ s.title() }}",
    "tojson_arguments": "{{ xs|tojson }} {{ {'b': 1, 'a': [1, 2]}|tojson(indent=2) }} "
                        "{{ 'é<'|tojson }} {{ {'b': 1, 'a': 2}|tojson(sort_keys=true) }} "
                        "{{ [1, {'a': 2}]|tojson(separators=[',', ':']) }} "
                        "{{ 'é'|tojson(ensure_ascii=true) }}",
    "served_filters": "{{ s|length }}{{ ' x '|trim }}{{ 'xax'|trim('x') }}{{ 1|trim }}"
                      "{{ xs|join(', ') }}{{ xs|join }}"
                      "{{ [{'a': 1}, {'a': 2}]|join('-', attribute='a') }}"
                      "{% for k, v in d|items %}{{ k }}={{ v }};{% endfor %}",
    "reject": "{{ [0, 1, '', 'a']|reject|join(',') }}{{ [1, 'a', none]|reject('string')|join }}"
              "{{ ['a', 'code_interpreter']|reject('equalto', 'code_interpreter')|join(', ') }}",
    "globals": "{{ raise_exception is defined }}{{ strftime_now('%d %b %Y') }}"
               "{{ namespace(a=1).a }}",
}


@pytest.mark.parametrize("name", CONSTRUCTS)
def test_construct_renders_as_transformers_jinja2(name):
    """Each construct's template gives jinja2's string under transformers'
    environment, with nothing failing on either side."""
    want = _reference(CONSTRUCTS[name], **_CONTEXT)
    assert want[0] == "ok", want
    assert _port(CONSTRUCTS[name], **_CONTEXT) == want


def test_the_known_names_are_jinja2s():
    assert chat_template.JINJA_FILTERS == frozenset(jinja2.filters.FILTERS)
    assert chat_template.JINJA_TESTS == frozenset(jinja2.tests.TESTS)
    assert chat_template.JINJA_GLOBALS == frozenset(jinja2.Environment().globals)
    assert set(chat_template.FILTERS) <= chat_template.JINJA_FILTERS
    assert set(chat_template.TESTS) <= chat_template.JINJA_TESTS


# -- the families ---------------------------------------------------------------------


def _both(d: str):
    return HfTokenizer(d), JaxHfTokenizer(d)


@pytest.mark.parametrize("repo", chip_smoke.CHAT_TEMPLATES)
def test_family_template_renders_and_encodes_as_the_reference(family_dirs, repo):
    """The string and the ids of every conversation of the corpus, with and
    without two tools, equal the reference HfTokenizer's."""
    tok, ref = _both(family_dirs[repo])
    rendered = 0
    for name, messages in CORPUS.items():
        for tools in (None, TOOLS):
            want = ref.apply_chat_template(messages, tools=tools)
            got = tok.apply_chat_template(messages, tools=tools)
            assert got == want, (name, tools is not None)
            assert tok.encode(got) == ref.encode(want), (name, tools is not None)
            rendered += want != render_fallback_template(messages)
    assert rendered >= len(CORPUS)  # the template, not the fallback, served most


_TEXT = st.lists(st.sampled_from(list("ab \n\t{}%#'\"<>|é日😀") + [
    "<think>", "</think>", "{{ x }}", "<tool_response>", "</tool_response>", "<|eot|>"]),
    max_size=12).map("".join)
_MESSAGE = st.fixed_dictionaries(
    {"role": st.sampled_from(["system", "user", "assistant", "tool"]),
     "content": _TEXT | st.lists(st.fixed_dictionaries(
         {"type": st.just("text"), "text": _TEXT}), max_size=2)},
    optional={"name": st.sampled_from(["ada", "bob"])})


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(repo=st.sampled_from(sorted(chip_smoke.CHAT_TEMPLATES)),
       messages=st.lists(_MESSAGE, min_size=1, max_size=6),
       tools=st.sampled_from([None, TOOLS[:1], TOOLS]))
def test_random_conversations_render_as_the_reference(family_dirs, tokenizer_pairs, repo,
                                                      messages, tools):
    tok, ref = tokenizer_pairs[repo]
    want = ref.apply_chat_template(messages, tools=tools)
    assert tok.apply_chat_template(messages, tools=tools) == want
    assert tok.encode(want) == ref.encode(want)


@pytest.fixture(scope="module")
def tokenizer_pairs(family_dirs):
    return {repo: _both(d) for repo, d in family_dirs.items()}


# -- fallback and refusal -------------------------------------------------------------

GEMMA = chip_smoke.CHAT_TEMPLATES["google/gemma-2b-it"]
FALLBACKS = {
    "gemma_system_message": (GEMMA, CORPUS["system"]),
    "gemma_roles_not_alternating": (GEMMA, [{"role": "user", "content": "a"},
                                            {"role": "user", "content": "b"}]),
    "undefined_attribute": ("{{ messages[0].nothing.deeper }}", CORPUS["one_turn"]),
    "messages_append": ("{{ messages.append({'role': 'x'}) }}{{ messages|length }}",
                        CORPUS["one_turn"]),
    "unknown_filter": ("{% for m in messages %}{{ m.content | shout }}{% endfor %}",
                       CORPUS["one_turn"]),
    "syntax_error": ("{% for m in messages %}{{ m.content }}", CORPUS["one_turn"]),
}


@pytest.mark.parametrize("name", FALLBACKS)
def test_what_jinja2_fails_on_gives_the_reference_fallback(base_dir, tmp_path, name):
    template, messages = FALLBACKS[name]
    tok, ref = _both(_templated(base_dir, str(tmp_path / "d"), template=template))
    want = ref.apply_chat_template(messages)
    assert want == render_fallback_template(messages)
    assert tok.apply_chat_template(messages) == want


REFUSED = {
    "sort": "{% for m in messages|sort(attribute='role') %}{{ m.content }}{% endfor %}",
    "unique": "{{ messages[0].content|unique|join }}",
    "dictsort": "{% for k, v in messages[0]|dictsort %}{{ k }}{% endfor %}",
    "cycler": "{% set c = cycler('a', 'b') %}{% for m in messages %}{{ c.next() }}{% endfor %}",
    "recursive": "{% for m in messages recursive %}{{ m.role }}{% endfor %}",
    "block": "{% block turns %}{% for m in messages %}{{ m.role }}{% endfor %}{% endblock %}",
    "macro": "{% macro turn(m) %}{{ m.role }}{% endmacro %}{% for m in messages %}{{ turn(m) }}"
             "{% endfor %}",
    "call": "{% call '<{}>'.format(messages[0].content) %}{% endcall %}",
    "filter": "{% filter trim %} {{ messages[0].content }} {% endfilter %}",
    "with": "{% with m = messages[0] %}{{ m.content }}{% endwith %}",
    "print": "{% print messages[0].content %}",
    "cycle": "{% for m in messages %}{{ loop.cycle('a', 'b') }}{{ m.content }}{% endfor %}",
    "depth": "{% for m in messages %}{{ loop.depth }}{{ m.content }}{% endfor %}",
    "format": "{{ '{}: {}'.format(messages[0].role, messages[0].content) }}",
    "range": "{% for i in range(2) %}{{ messages[0].content }}{% endfor %}",
    "divisibleby": "{% for m in messages %}{% if loop.index is divisibleby 2 %}x{% endif %}"
                   "{{ m.content }}{% endfor %}",
    "args": "{{ namespace(*[]).a|length }}{{ messages[0].content }}",
}


@pytest.mark.parametrize("name", REFUSED)
def test_a_construct_the_subset_lacks_is_refused_by_name(base_dir, tmp_path, name):
    """The reference renders these templates (not its fallback); the port
    raises NotImplementedError naming the construct, at every chat."""
    tok, ref = _both(_templated(base_dir, str(tmp_path / "d"), template=REFUSED[name]))
    messages = CORPUS["one_turn"]
    assert ref.apply_chat_template(messages) != render_fallback_template(messages)
    for _ in range(2):
        with pytest.raises(NotImplementedError, match=name):
            tok.apply_chat_template(messages)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


_SERVE = ["run", "in=http", "out=torch", "--port", "0", "--device", "cpu", "--dtype", "float32",
          "--page-size", "16", "--max-context", "1024", "--num-pages", "96",
          "--prefill-chunk", "64"]


def test_a_refused_template_is_a_501_naming_it_and_completions_serve(base_dir, tmp_path):
    d = _templated(base_dir, str(tmp_path / "d"), template=REFUSED["sort"])
    server = start_server(_SERVE + ["--model", "tiny", "--tokenizer", d])
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.url + "/v1/chat/completions",
                  {"model": "tiny", "messages": CORPUS["one_turn"], "max_tokens": 2})
        assert e.value.code == 501
        assert "'sort'" in json.dumps(json.load(e.value)["error"])
        done = _post(server.url + "/v1/completions", {"model": "tiny", "prompt": [5, 6, 7],
                                                      "max_tokens": 2,
                                                      "ext": {"ignore_eos": True}})
        assert done["usage"]["completion_tokens"] == 2
    finally:
        server.stop()


# -- where the template comes from, and its context -----------------------------------

_SHOW = "{{ 'NAME' }}:{% for m in messages %}{{ m.content }}{% endfor %}:{{ tools is none }}"


def _show(name: str) -> str:
    return _SHOW.replace("NAME", name)


PRECEDENCE = {
    # a chat_template.jinja file over tokenizer_config.json's entry
    "jinja_file_over_config": dict(template=_show("config"), jinja=_show("file")),
    # a named pair in tokenizer_config.json: "tool_use" with tools
    "named_list_in_config": dict(template=[{"name": "default", "template": _show("default")},
                                           {"name": "tool_use", "template": _show("tools")}]),
    # additional_chat_templates/ beside chat_template.jinja, over the config
    "additional_files": dict(template=_show("config"), jinja=_show("file"),
                             extra={"tool_use": _show("extra")}),
    # named templates and no default: a chat without tools falls back
    "no_default": dict(template=_show("config"), extra={"tool_use": _show("extra")}),
}


@pytest.mark.parametrize("case", PRECEDENCE)
def test_template_precedence_equals_transformers(base_dir, tmp_path, case):
    tok, ref = _both(_templated(base_dir, str(tmp_path / "d"), **PRECEDENCE[case]))
    messages = CORPUS["one_turn"]
    for tools in (None, [], TOOLS):
        assert tok.apply_chat_template(messages, tools=tools) == \
            ref.apply_chat_template(messages, tools=tools)
    if case == "jinja_file_over_config":
        assert tok.apply_chat_template(messages).startswith("file:")


@pytest.mark.parametrize("kind", KINDS)
def test_the_special_tokens_in_the_context_are_transformers(tokenizer_dirs, tmp_path, kind):
    show = ("{{ bos_token }}|{{ eos_token }}|{{ unk_token }}|{{ pad_token }}|{{ sep_token }}|"
            "{{ additional_special_tokens }}|{{ documents }}|{{ add_generation_prompt }}|"
            "{{ tools }}")
    tok, ref = _both(_templated(tokenizer_dirs[kind], str(tmp_path / "d"), template=show))
    assert tok.apply_chat_template(CORPUS["one_turn"]) == \
        ref.apply_chat_template(CORPUS["one_turn"])


def test_a_legacy_special_tokens_map_overrides_the_config_as_in_transformers(base_dir,
                                                                            tmp_path):
    """With no added_tokens_decoder in tokenizer_config.json, transformers
    takes special_tokens_map.json's tokens over the config's: the context's
    bos and eos and the ids of text holding them equal the reference's."""
    d = str(tmp_path / "d")
    shutil.copytree(base_dir, d)
    with open(os.path.join(d, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<|start|>", "eos_token": "<|stop|>",
                   "additional_special_tokens": ["<|x|>"],
                   "chat_template": "{{ bos_token }}{{ messages[0].content }}{{ eos_token }}"
                                    "{{ additional_special_tokens }}"}, f)
    tok, ref = _both(d)
    messages = [{"role": "user", "content": "a<|tool|>b<|start|>c<|begin|>"}]
    want = ref.apply_chat_template(messages)
    assert want.startswith("<|begin|>a")
    assert tok.apply_chat_template(messages) == want
    assert tok.encode(want) == ref.encode(want)
    assert tok.vocab_size == ref.vocab_size


def test_chip_smokes_chat_digest_is_transformers_render(base_dir, tmp_path):
    """chip_smoke.CHAT_RENDER_SHA256 is the reference's render of the
    smoke's templated chat under its directory's tokenizer_config.json."""
    d = str(tmp_path / "d")
    shutil.copytree(base_dir, d)
    os.remove(os.path.join(d, "special_tokens_map.json"))  # the smoke writes none
    with open(os.path.join(d, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(chip_smoke.hf_tokenizer_config(), f, ensure_ascii=False)
    tok, ref = _both(d)
    want = ref.apply_chat_template(chip_smoke.CHAT_MESSAGES, tools=chip_smoke.CHAT_TOOLS)
    assert want != render_fallback_template(chip_smoke.CHAT_MESSAGES)
    assert hashlib.sha256(want.encode()).hexdigest() == chip_smoke.CHAT_RENDER_SHA256
    assert tok.apply_chat_template(chip_smoke.CHAT_MESSAGES, tools=chip_smoke.CHAT_TOOLS) == want


# -- the preprocessor: ext.use_raw_prompt, then the template with tools -----------------

RAW_BODY = {"model": "m", "tools": TOOLS, "messages": [
    {"role": "system", "content": "sys"},
    {"role": "user", "content": [{"type": "text", "text": "two "}, {"type": "image_url"},
                                 {"type": "text", "text": "parts"}]},
    {"role": "assistant", "content": None},
    {"role": "user", "content": "last {{ x }}"}]}


@pytest.mark.parametrize("tokenizer", ["templated", "plain", "byte"])
@pytest.mark.parametrize("raw", [True, False])
def test_preprocess_chat_ids_equal_the_reference(family_dirs, base_dir, tokenizer, raw):
    """ext.use_raw_prompt tokenizes the contents joined by a newline; else
    the template renders the messages and the request's tools: the prompt
    ids equal the JAX package's OpenAIPreprocessor's for the same body."""
    if tokenizer == "byte":
        tok, ref = ByteTokenizer(), JaxByteTokenizer()
    else:
        tok, ref = _both(family_dirs["meta-llama/Llama-3.1-8B-Instruct"]
                         if tokenizer == "templated" else base_dir)
    body = {**RAW_BODY, "ext": {"use_raw_prompt": raw}}
    want = JaxPreprocessor(ref).preprocess_chat(JaxChatRequest(**body)).token_ids
    got = OpenAIPreprocessor(tok).preprocess_chat(ChatCompletionRequest.from_json(body))
    assert got.token_ids == want
    if raw:
        assert tok.decode(want) == "sys\ntwo parts\nlast {{ x }}"


# -- the slice: a templated chat with tools through the CLI's server ------------------


def test_a_templated_chat_with_tools_serves_the_jax_engines_ids(base_dir, tmp_path):
    """A tiny checkpoint directory with Qwen2.5's template: the port's CLI
    server answers a chat with two tools with usage.prompt_tokens and greedy
    ids equal to JaxEngine's on the ids the reference's preprocessor makes
    of the same body."""
    d = _templated(base_dir, str(tmp_path / "ckpt"),
                   template=chip_smoke.CHAT_TEMPLATES["Qwen/Qwen2.5-7B-Instruct"])
    cfg = transformers.LlamaConfig(vocab_size=768, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
                                   rope_theta=10000.0)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(d, safe_serialization=True)
    body = {"model": d, "messages": CORPUS["system"], "tools": chip_smoke.CHAT_TOOLS,
            "max_tokens": 6, "temperature": 0, "ext": {"ignore_eos": True,
                                                         "return_token_ids": True}}
    ids = JaxPreprocessor(JaxHfTokenizer(d)).preprocess_chat(JaxChatRequest(**body)).token_ids
    assert len(ids) > 300  # the tools are in the prompt
    server = start_server(_SERVE + ["--model", d])
    try:
        resp = _post(server.url + "/v1/chat/completions", body)
    finally:
        server.stop()
    eng = JaxEngine(JaxEngineConfig.for_tests(model=d, page_size=16, max_pages_per_seq=64,
                                              num_pages=96, prefill_chunk=64))
    want = _drive(eng, JaxSampling, [("r", ids, dict(temperature=0.0, max_tokens=6,
                                                    ignore_eos=True))])["r"]
    assert resp["usage"]["prompt_tokens"] == len(ids)
    assert resp["choices"][0]["token_ids"] == want
