"""Differential fuzzing of dynamo_tpu_torch's chat-template subset against
jinja2 under transformers' environment.

    JAX_PLATFORMS=cpu python scripts/torch_chat_template_fuzz.py [--seed S] [--n N]

Runs on a machine with jinja2 and transformers (the CPU test box, not the
card's). Three generators of random templates, each N templates a seed:
`whitespace` (text, tags, comments and raw blocks with random `-`/`+`
modifiers), `expressions` (literals, names, operators, filters, tests,
subscripts, slices and conditionals nested four deep) and `statements`
(`set`, `for` with `if`/`else`, `if`, block `set`, `break`/`continue`,
`generation`, `namespace`). A template
agrees when both render the same string or both fail (the reference's
fallback); a refusal by name (NotImplementedError) is not counted as a
difference, and a jinja2 output holding an object's address is skipped.
Prints one JSON line per generator: templates, differences, the first few.
"""

import argparse
import json
import random
import sys
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from transformers.utils.chat_template_utils import _compile_jinja_template  # noqa: E402

from dynamo_tpu_torch.preprocessor.chat_template import ChatTemplate  # noqa: E402

TEXT = ["", " ", "  ", "\n", "\n\n", "\t", " \n ", "a", "b c", "\n  ", "  \n", "x\n  ", "\r\n",
        " y "]
ATOMS = ["1", "2", "0", "-1", "2.5", "'ab'", "\"x y\"", "none", "true", "false", "xs", "d", "s",
         "n", "u", "[1, 2]", "{'a': 1}", "(1, 'b')", "messages", "ns.a", "loop"]
BINOPS = ["+", "-", "*", "/", "//", "%", "**", "~", "==", "!=", "<", ">=", "in", "not in", "and",
          "or"]
FILTERS = ["trim", "length", "tojson", "tojson(indent=2)", "join(',')", "join",
           "reject|join(',')", "reject('string')|join", "reject('equalto', 1)|join",
           "trim('a')"]
TESTS = ["defined", "undefined", "none", "string", "mapping", "iterable", "sequence", "number",
         "true", "false", "boolean", "equalto 1"]
CONTEXT = dict(xs=[1, 2, 3], d={"a": 1, "b": [1]}, s=" Hi there ", n=None, x=True,
               messages=[{"role": "user", "content": "q"}])


def whitespace(rng: random.Random) -> str:
    def mod():
        return rng.choice(["", "", "-", "+"])

    def var():
        return "{{" + mod() + rng.choice([" x ", " 'v' ", " xs|length ",
                                          " loop.index if loop is defined else 0 "]) \
            + rng.choice(["", "", "-"]) + "}}"

    def tag(body):
        return "{%" + mod() + " " + body + " " + mod() + "%}"

    def block(depth):
        kind = rng.choice(["if", "for", "set", "comment", "raw"] if depth < 3
                          else ["set", "comment"])
        if kind == "if":
            return tag("if x") + body(depth + 1) + (
                tag("else") + body(depth + 1) if rng.random() < 0.5 else "") + tag("endif")
        if kind == "for":
            return tag("for i in xs") + body(depth + 1) + tag("endfor")
        if kind == "set":
            return tag("set y = 1")
        if kind == "raw":
            return tag("raw") + rng.choice(TEXT) + "{{ no }}" + rng.choice(TEXT) + tag("endraw")
        return "{#" + mod() + " c " + mod() + "#}"

    def body(depth=0):
        parts = []
        for _ in range(rng.randint(0, 4)):
            r = rng.random()
            parts.append(rng.choice(TEXT) if r < 0.4 else var() if r < 0.6 else block(depth))
        return "".join(parts)

    return body() + rng.choice(["", "\n", "\n\n", " "])


def expressions(rng: random.Random) -> str:
    def expr(depth=0):
        r = rng.random()
        if depth > 3 or r < 0.3:
            return rng.choice(ATOMS)
        if r < 0.5:
            return f"{expr(depth + 1)} {rng.choice(BINOPS)} {expr(depth + 1)}"
        if r < 0.62:
            return f"{expr(depth + 1)}|{rng.choice(FILTERS)}"
        if r < 0.72:
            return f"{expr(depth + 1)} is {rng.choice(['', 'not '])}{rng.choice(TESTS)}"
        if r < 0.8:
            return rng.choice(["not ", "-", "+"]) + expr(depth + 1)
        if r < 0.87:
            tail = f" else {expr(depth + 1)}" if rng.random() < 0.6 else ""
            return f"{expr(depth + 1)} if {expr(depth + 1)}{tail}"
        if r < 0.93:
            return expr(depth + 1) + rng.choice(["[0]", "[1:]", "[::-1]", "['a']", ".a",
                                                 ".items()", ".keys()", "[-1]", ".upper()",
                                                 ".split()"])
        return f"({expr(depth + 1)})"

    return "{% set ns = namespace(a=2) %}{{ " + expr() + " }}"


def statements(rng: random.Random) -> str:
    def val():
        return rng.choice(["1", "a", "b", "x", "a + 1", "x ~ 'q'",
                           "loop.index if loop is defined else 0", "ns.v", "[1, 2]", "'s'",
                           "a is defined"])

    def stmt(d):
        r = rng.random()
        if d > 2 or r < 0.25:
            return "{{ " + val() + " }}"
        if r < 0.4:
            target = rng.choice(["a", "b", "x", "ns.v", "a, b"])
            return "{% set " + target + " = " + (val() if rng.random() < 0.8 else "1, 2") + " %}"
        if r < 0.5:
            return ("{% for x in " + rng.choice(["[1, 2, 3]", "[]", "'ab'", "a",
                                                  "[[1, 2], [3, 4]]"])
                    + rng.choice(["", " if x"]) + " %}" + body(d + 1)
                    + rng.choice(["", "{% else %}E" + body(d + 1)]) + "{% endfor %}")
        if r < 0.6:
            return ("{% if " + val() + " %}" + body(d + 1)
                    + rng.choice(["", "{% else %}" + body(d + 1)]) + "{% endif %}")
        if r < 0.75:
            return "{% set b" + rng.choice(["", " | trim", " | length"]) + " %}" + body(d + 1) \
                + "{% endset %}"
        if r < 0.85:
            return rng.choice(["{% break %}", "{% continue %}"])
        if r < 0.95:
            return "{% generation %}" + body(d + 1) + "{% endgeneration %}"
        return "{% set ns = namespace(v=0) %}"

    def body(d=0):
        return "".join(stmt(d) for _ in range(rng.randint(0, 3)))

    return "{% set ns = namespace(v=5) %}" + body() + "|{{ a }}{{ b }}{{ x }}{{ ns.v }}"


def _render(render, source: str) -> tuple:
    try:
        return "ok", render(source)
    except NotImplementedError:
        return "refused", None
    except Exception as e:
        return "error", type(e).__name__


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=2000, help="templates per generator")
    args = ap.parse_args()
    warnings.simplefilter("ignore")  # jinja2's generated code warns on `1[0]`
    differ = 0
    for gen in (whitespace, expressions, statements):
        rng = random.Random(f"{gen.__name__}-{args.seed}")
        diffs, refused = [], 0
        for _ in range(args.n):
            source = gen(rng)
            want = _render(lambda t: _compile_jinja_template(t).render(**CONTEXT), source)
            got = _render(lambda t: ChatTemplate(t).render(**CONTEXT), source)
            if got[0] == "refused":
                refused += 1
            elif got[0] != want[0] or (got[0] == "ok" and got[1] != want[1]):
                if not (want[0] == "ok" and " at 0x" in want[1]):
                    diffs.append({"template": source, "jinja2": want, "port": got})
        differ += len(diffs)
        print(json.dumps({"generator": gen.__name__, "seed": args.seed, "templates": args.n,
                          "refused": refused, "differences": len(diffs),
                          "first": diffs[:3]}, ensure_ascii=False))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
