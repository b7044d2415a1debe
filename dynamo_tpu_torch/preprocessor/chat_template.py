"""A standard-library subset of Jinja2 that renders a tokenizer's chat
template as transformers does.

The counterpart of transformers' `utils/chat_template_utils.py`
(`_compile_jinja_template`, `render_jinja_template`), which the JAX
package reaches through `apply_chat_template`. The card machine has no
jinja2, so this module is a lexer (jinja2's rules, whitespace control
included), a parser into a small node tree (jinja2's grammar and
precedence) and a tree-walking evaluator, over the environment
transformers builds: `ImmutableSandboxedEnvironment(trim_blocks=True,
lstrip_blocks=True)` with the `loopcontrols` extension and its
`generation` tag, `keep_trailing_newline` off (one trailing newline of the
template is dropped), its own `tojson` (`json.dumps` with ensure_ascii,
indent, separators and sort_keys, not Jinja's HTML-safe one) and the
globals `raise_exception` and `strftime_now`. A template is parsed once
(`ChatTemplate(source)`) and rendered per request
(`ChatTemplate.render(**context)`).

The constructs, as the served families' templates use them (Llama-3.1 and
3.2 Instruct, Qwen2, Qwen2.5, Qwen3, Phi-3, Phi-4, Gemma-it,
DeepSeek-R1-Distill-Llama), all served:
- tags: `{{ }}`, `{% %}`, `{# #}`, the `-` and `+` modifiers, trim_blocks
  and lstrip_blocks around block and comment tags (not around `{{ }}`),
  `raw`;
- statements: `if`/`elif`/`else`, `for` with tuple targets, an `if`
  filter and `else` (which also runs when every iteration left by `break`
  or `continue`, as jinja2's flag clears only at the body's end),
  `break`/`continue`, `set` (a name, a tuple, `ns.attr`, and block `set
  ... endset` with filters), `generation`/`endgeneration` (its body
  renders, in a frame of its own);
- expressions: string, integer, float, boolean, none, list, tuple and
  dict literals; `.attr` (Python's attribute first, then the item:
  `message.items` is the dict's method) and `[item]` (the item first, then
  the attribute); slices with a step; calls with positional and keyword
  arguments; filters (binding tighter than `+`); tests with `is` and `is
  not`; `in`/`not in`; `and`/`or`/`not`; chained comparisons; `+ - * / //
  % **` and `~`; unary `-`/`+`; the conditional expression with or
  without `else`;
- values: `{{ }}` prints Python's `str()`; `loop.index`, `index0`,
  `revindex`, `revindex0`, `first`, `last`, `length`, `previtem`,
  `nextitem`; jinja2's `Undefined` (prints '', is falsy, iterates empty,
  has length 0, compares equal only to another undefined, and raises on
  an attribute, an item, arithmetic or a call);
- scoping, as jinja2's compiler decides it: each `for` iteration,
  `generation` and block-set body is a frame of its own (a `set` there
  does not leak out; `namespace` carries values out), `if` opens none, and
  a frame's name whose first mention in the frame binds it, and which no
  enclosing frame mentions, is undefined until bound, to the frames nested
  in it too (jinja2's `missing`);
- compile-time folding, as jinja2's optimizer does it: an expression of
  literals is computed once, so a literal's slice goes through the
  sandbox (an unsliceable one prints ''), what `and`, `or` or a
  conditional skip is never compiled, and a negative constant base of
  `**` is read as Python reads `-2 ** x`;
- the sandbox: `_`-prefixed attributes and the methods that mutate a
  list or dict are unsafe (printing one gives '', calling it raises);
- filters: items, join, length, reject, tojson, trim;
- tests: `defined`, `undefined`, `none`, `string`, `mapping`,
  `iterable`, `sequence`, `number`, `boolean`, `true`, `false` and
  `equalto` (Llama-3.1's `reject('equalto', ...)`);
- globals: `raise_exception`, `strftime_now`, `namespace`.

Errors keep transformers' and the JAX package's behaviour. Where jinja2
itself would fail (a syntax error, a filter or test jinja2 does not have
either, outside an `if` or conditional expression where jinja2 defers that
check to the call, a render error such as `raise_exception`, an attribute
of an undefined value or a sandbox refusal), this module raises
`TemplateError` or the Python error jinja2 would let through, and the
caller serves the structured fallback, as the reference's
`except Exception` does. Where jinja2 has a construct this subset lacks
(its other filters, tests and globals; the `macro`, `call`, `filter`,
`with`, `print`, `block`, `extends`, `include`, `import`, `from` and
`autoescape` tags; `*args` and `**kwargs` in a call; recursive loops;
`loop.cycle`, `loop.changed`, `loop.depth`; `str.format`), it raises
`NotImplementedError` naming it: parsing does for what the source shows,
which `ChatTemplate` holds and raises again at each render, and rendering
does for `loop.*` and `str.format`, which only the values show. The
reference would render that template, so the port must not serve another
prompt.
"""

from __future__ import annotations

import json
import operator
import re
import types
from collections import abc
from datetime import datetime
from numbers import Number
from typing import Any, Optional


class TemplateError(Exception):
    """An error jinja2 raises for the same template and context."""


class TemplateSyntaxError(TemplateError):
    pass


class UndefinedError(TemplateError):
    pass


class SecurityError(TemplateError):
    pass


def _refused(construct: str) -> NotImplementedError:
    return NotImplementedError(f"the chat template uses jinja2's {construct}, which the chat "
                               "template subset of dynamo_tpu_torch does not serve")


#: jinja2 3.1's built-in filters, tests and globals: a name among them that
#: this module lacks is refused by name, any other is jinja2's error too
JINJA_FILTERS = frozenset((
    "abs", "attr", "batch", "capitalize", "center", "count", "d", "default", "dictsort", "e",
    "escape", "filesizeformat", "first", "float", "forceescape", "format", "groupby", "indent",
    "int", "items", "join", "last", "length", "list", "lower", "map", "max", "min", "pprint",
    "random", "reject", "rejectattr", "replace", "reverse", "round", "safe", "select",
    "selectattr", "slice", "sort", "string", "striptags", "sum", "title", "tojson", "trim",
    "truncate", "unique", "upper", "urlencode", "urlize", "wordcount", "wordwrap", "xmlattr"))
JINJA_TESTS = frozenset((
    "!=", "<", "<=", "==", ">", ">=", "boolean", "callable", "defined", "divisibleby", "eq",
    "equalto", "escaped", "even", "false", "filter", "float", "ge", "greaterthan", "gt", "in",
    "integer", "iterable", "le", "lessthan", "lower", "lt", "mapping", "ne", "none", "number",
    "odd", "sameas", "sequence", "string", "test", "true", "undefined", "upper"))
JINJA_GLOBALS = frozenset(("cycler", "dict", "joiner", "lipsum", "namespace", "range"))

_MISSING = object()
#: a frame's name that jinja2 starts as `missing` (stored in the frame before
#: any reference to it, and known to no enclosing frame): undefined until
#: stored, also to the frames nested in it
_UNSET = object()


# -- values ---------------------------------------------------------------------------


class Undefined:
    """jinja2's default Undefined: '' printed, falsy, empty when iterated,
    length 0, equal only to another undefined; anything else raises."""

    __slots__ = ("_hint", "_obj", "_name", "_exc")

    def __init__(self, hint: Optional[str] = None, obj: Any = _MISSING,
                 name: Optional[str] = None, exc: type = UndefinedError):
        self._hint, self._obj, self._name, self._exc = hint, obj, name, exc

    def _fail(self, *args, **kwargs):
        if self._hint:
            msg = self._hint
        elif self._obj is _MISSING:
            msg = f"{self._name!r} is undefined"
        elif not isinstance(self._name, str):
            msg = f"{type(self._obj).__name__} object has no element {self._name!r}"
        else:
            msg = f"{type(self._obj).__name__!r} object has no attribute {self._name!r}"
        raise self._exc(msg)

    def __getattr__(self, name: str):
        if name[:2] == "__" and name[-2:] == "__":
            raise AttributeError(name)
        return self._fail()

    __add__ = __radd__ = __sub__ = __rsub__ = _fail
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _fail
    __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _fail
    __pos__ = __neg__ = __call__ = __getitem__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = _fail
    __int__ = __float__ = __complex__ = __pow__ = __rpow__ = _fail

    def __eq__(self, other):
        return type(self) is type(other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return id(type(self))

    def __str__(self):
        return ""

    def __len__(self):
        return 0

    def __iter__(self):
        yield from ()

    def __bool__(self):
        return False

    def __repr__(self):
        return "Undefined"


class Namespace:
    """`namespace(...)`: attributes a `set ns.attr = ...` changes from any
    scope."""

    def __init__(self, *args, **kwargs):
        self.attrs = dict(*args, **kwargs)

    def __repr__(self):
        return f"<Namespace {self.attrs!r}>"


class LoopContext:
    """The `loop` variable of a `for` body."""

    def __init__(self, items: list):
        self._items = items
        self.index0 = -1

    @property
    def length(self):
        return len(self._items)

    def __len__(self):
        return self.length

    @property
    def index(self):
        return self.index0 + 1

    @property
    def revindex0(self):
        return self.length - self.index

    @property
    def revindex(self):
        return self.length - self.index0

    @property
    def first(self):
        return self.index0 == 0

    @property
    def last(self):
        return self.index0 == self.length - 1

    @property
    def previtem(self):
        if self.first:
            return Undefined("there is no previous item")
        return self._items[self.index0 - 1]

    @property
    def nextitem(self):
        if self.last:
            return Undefined("there is no next item")
        return self._items[self.index0 + 1]

    def __getattr__(self, name: str):
        if name in ("cycle", "changed", "depth", "depth0"):
            raise _refused(f"loop.{name}")
        raise AttributeError(name)

    def __call__(self, iterable):
        raise TypeError("The loop must have the 'recursive' marker to be called recursively.")

    def __repr__(self):
        return f"<LoopContext {self.index}/{self.length}>"


def _raise_exception(message):
    raise TemplateError(message)


def _strftime_now(format):
    return datetime.now().strftime(format)


_GLOBALS = {"raise_exception": _raise_exception, "strftime_now": _strftime_now,
            "namespace": Namespace}

# -- the sandbox ----------------------------------------------------------------------

_MUTATING = (
    (abc.MutableMapping, frozenset(("clear", "pop", "popitem", "setdefault", "update"))),
    (abc.MutableSequence, frozenset(("append", "clear", "pop", "reverse", "insert", "sort",
                                     "extend", "remove"))),
)


def _is_safe_attribute(obj, attr: str) -> bool:
    """ImmutableSandboxedEnvironment.is_safe_attribute."""
    if attr.startswith("_"):
        return False
    if isinstance(obj, type) and attr == "mro":
        return False
    if isinstance(obj, (types.CodeType, types.TracebackType, types.FrameType)):
        return False
    if isinstance(obj, types.GeneratorType) and attr in ("gi_frame", "gi_code"):
        return False
    for kind, unsafe in _MUTATING:
        if isinstance(obj, kind):
            return attr not in unsafe
    return True


def _unsafe(obj, attr):
    return Undefined(f"access to attribute {attr!r} of {type(obj).__name__!r} object is unsafe.",
                     obj=obj, name=attr, exc=SecurityError)


def _attr_value(obj, attr, value):
    if not _is_safe_attribute(obj, attr):
        return _unsafe(obj, attr)
    if isinstance(obj, str) and attr in ("format", "format_map"):  # the sandbox's own
        raise _refused(f"str.{attr}")
    return value


def getattr_(obj, attr: str):
    """`obj.attr`: Python's attribute first, then the item."""
    if isinstance(obj, Undefined):
        obj._fail()
    if isinstance(obj, Namespace):
        value = obj.attrs.get(attr, _MISSING)
        if value is _MISSING:
            return Undefined(obj=obj, name=attr)
        return value if _is_safe_attribute(obj, attr) else _unsafe(obj, attr)
    try:
        value = getattr(obj, attr)
    except AttributeError:
        try:
            return obj[attr]
        except (TypeError, LookupError):
            pass
    else:
        return _attr_value(obj, attr, value)
    return Undefined(obj=obj, name=attr)


def getitem(obj, arg):
    """`obj[arg]`: the item first, then (for a string) the attribute."""
    if isinstance(obj, Undefined):
        obj._fail()
    try:
        return obj[arg]
    except (TypeError, LookupError):
        if isinstance(arg, str):
            if isinstance(obj, Namespace):
                return getattr_(obj, arg)
            try:
                value = getattr(obj, arg)
            except AttributeError:
                pass
            else:
                return _attr_value(obj, arg, value)
    return Undefined(obj=obj, name=arg)


# -- filters and tests ----------------------------------------------------------------


def _attrgetter(attribute):
    if isinstance(attribute, str):
        parts = [int(x) if x.isdigit() else x for x in attribute.split(".")]
    else:
        parts = [attribute]

    def get(item):
        for part in parts:
            item = getitem(item, part)
        return item
    return get


def _call_filter(name, value, args, kwargs):
    fn = FILTERS.get(name)
    if fn is None:
        raise TemplateError(f"No filter named {name!r} found.")
    return fn(value, *args, **kwargs)


def _call_test(name, value, args, kwargs):
    fn = TESTS.get(name)
    if fn is None:
        if name in JINJA_TESTS:
            raise _refused(f"test {name!r}")
        raise TemplateError(f"No test named {name!r} found.")
    return fn(value, *args, **kwargs)


def _tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
    return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                      sort_keys=sort_keys)


def _join(value, d="", attribute=None):
    if attribute is not None:
        value = map(_attrgetter(attribute), value)
    return str(d).join(map(str, value))


def _items(value):
    if isinstance(value, Undefined):
        return
    if not isinstance(value, abc.Mapping):
        raise TypeError("Can only get item pairs from a mapping.")
    yield from value.items()


def _reject(value, *args, **kwargs):
    if value:
        if args:
            name, rest = args[0], args[1:]

            def func(item):
                return _call_test(name, item, rest, kwargs)
        else:
            func = bool
        for item in value:
            if not func(item):
                yield item


FILTERS = {
    "items": _items, "join": _join, "length": len, "reject": _reject, "tojson": _tojson,
    "trim": lambda value, chars=None: (value if isinstance(value, str) else str(value)).strip(
        chars),
}


def _sequence(value):
    try:
        len(value)
        value.__getitem__  # noqa: B018
    except Exception:
        return False
    return True


def _iterable(value):
    try:
        iter(value)
    except TypeError:
        return False
    return True


TESTS = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None, "boolean": lambda v: v is True or v is False,
    "false": lambda v: v is False, "true": lambda v: v is True,
    "string": lambda v: isinstance(v, str), "mapping": lambda v: isinstance(v, abc.Mapping),
    "number": lambda v: isinstance(v, Number), "sequence": _sequence, "iterable": _iterable,
    "equalto": operator.eq,
}

# -- lexer ----------------------------------------------------------------------------

_WHITESPACE = re.compile(r"\s+")
_NEWLINE = re.compile(r"(\r\n|\r|\n)")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'" r'|"([^"\\]*(?:\\.[^"\\]*)*)")', re.S)
_INTEGER = re.compile(r"(0b(_?[0-1])+|0o(_?[0-7])+|0x(_?[\da-f])+|[1-9](_?\d)*|0(_?0)*)",
                      re.IGNORECASE)
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+|\.(\d+_)*\d+)",
                    re.IGNORECASE)
_NAME = re.compile(r"\w+")
_OPERATORS = {
    "+": "add", "-": "sub", "/": "div", "//": "floordiv", "*": "mul", "%": "mod",
    "**": "pow", "~": "tilde", "[": "lbracket", "]": "rbracket", "(": "lparen",
    ")": "rparen", "{": "lbrace", "}": "rbrace", "==": "eq", "!=": "ne", ">": "gt",
    ">=": "gteq", "<": "lt", "<=": "lteq", "=": "assign", ".": "dot", ":": "colon",
    "|": "pipe", ",": "comma", ";": "semicolon",
}
_OPERATOR = re.compile("|".join(re.escape(x) for x in sorted(_OPERATORS, key=lambda x: -len(x))))
_ROOT = re.compile(
    r"(.*?)(?:(?P<raw_begin>\{%(\-|\+|)\s*raw\s*(?:\-%\}\s*|%\}))"
    r"|(?P<variable_begin>\{\{(\-|\+|))|(?P<comment_begin>\{#(\-|\+|))"
    r"|(?P<block_begin>\{%(\-|\+|)))", re.M | re.S)
_COMMENT_END = re.compile(r"(.*?)((?:\+#\}|\-#\}\s*|#\}\n?))", re.M | re.S)
_BLOCK_END = re.compile(r"(?:\+%\}|\-%\}\s*|%\}\n?)", re.M | re.S)
_VARIABLE_END = re.compile(r"\-\}\}\s*|\}\}", re.M | re.S)
_RAW_END = re.compile(r"(.*?)((?:\{%(\-|\+|))\s*endraw\s*(?:\+%\}|\-%\}\s*|%\}\n?))",
                      re.M | re.S)


def _lstrip(text: str, sign: str, lstrip_ok: bool, line_starting: bool) -> str:
    """jinja2's whitespace control of the text before a tag: `-` strips all
    whitespace; otherwise lstrip_blocks strips the spaces between the
    line's start and a block or comment tag."""
    if sign == "-":
        return text.rstrip()
    if sign != "+" and lstrip_ok:
        l_pos = text.rfind("\n") + 1
        if (l_pos > 0 or line_starting) and _WHITESPACE.fullmatch(text, l_pos):
            return text[:l_pos]
    return text


def tokenize(source: str) -> list:
    """(type, value) tokens of a template, as jinja2's lexer gives them under
    trim_blocks and lstrip_blocks, ending with ("eof", "")."""
    lines = _NEWLINE.split(source)[::2]
    if lines[-1] == "":  # keep_trailing_newline is off
        del lines[-1]
    source = "\n".join(lines)
    out: list = []
    pos, n, line_starting = 0, len(source), True
    while pos < n:
        m = _ROOT.match(source, pos)
        if m is None:
            out.append(("data", source[pos:]))
            break
        kind = next(k for k in ("raw_begin", "variable_begin", "comment_begin", "block_begin")
                    if m.group(k) is not None)
        sign = next(g for g in m.groups()[2::2] if g is not None)
        text = _lstrip(m.group(1), sign, kind != "variable_begin", line_starting)
        if text:
            out.append(("data", text))
        line_starting = m.group()[-1:] == "\n"
        pos = m.end()
        if kind == "raw_begin":
            m = _RAW_END.match(source, pos)
            if m is None:
                raise TemplateSyntaxError("Missing end of raw directive")
            text = _lstrip(m.group(1), m.group(3), True, line_starting)
            if text:
                out.append(("data", text))
        elif kind == "comment_begin":
            m = _COMMENT_END.match(source, pos)
            if m is None:
                raise TemplateSyntaxError("Missing end of comment tag")
        else:
            out.append((kind, ""))
            pos, m = _tag(source, pos, kind, out)
            if m is None:
                break
        line_starting = m.group()[-1:] == "\n"
        pos = m.end()
    out.append(("eof", ""))
    return out


def _tag(source: str, pos: int, kind: str, out: list):
    """The tokens of one `{{ }}` or `{% %}` tag up to its end: (position,
    the end's match, or None at the end of the source)."""
    end = _VARIABLE_END if kind == "variable_begin" else _BLOCK_END
    balance: list = []
    while True:
        if not balance:
            m = end.match(source, pos)
            if m is not None:
                out.append(("variable_end" if kind == "variable_begin" else "block_end", ""))
                return pos, m
        m = _WHITESPACE.match(source, pos)
        if m is not None:
            pos = m.end()
            continue
        if pos >= len(source):
            return pos, None
        m = _FLOAT.match(source, pos)
        if m is not None:
            out.append(("float", float(m.group().replace("_", ""))))
        elif (m := _INTEGER.match(source, pos)) is not None:
            out.append(("integer", int(m.group().replace("_", ""), 0)))
        elif (m := _NAME.match(source, pos)) is not None:
            if not m.group().isidentifier():
                raise TemplateSyntaxError("Invalid character in identifier")
            out.append(("name", m.group()))
        elif (m := _STRING.match(source, pos)) is not None:
            try:
                value = m.group()[1:-1].encode("ascii", "backslashreplace").decode(
                    "unicode-escape")
            except Exception as e:
                raise TemplateSyntaxError(str(e)) from e
            out.append(("string", value))
        elif (m := _OPERATOR.match(source, pos)) is not None:
            op = m.group()
            if op in "([{":
                balance.append({"(": ")", "[": "]", "{": "}"}[op])
            elif op in ")]}":
                if not balance or balance.pop() != op:
                    raise TemplateSyntaxError(f"unexpected {op!r}")
            out.append((_OPERATORS[op], op))
        else:
            raise TemplateSyntaxError(f"unexpected char {source[pos]!r} at {pos}")
        pos = m.end()


# -- nodes ----------------------------------------------------------------------------


class _Scope:
    """A frame's variables: reads go to the nearest frame that holds the
    name, then the context and the globals."""

    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Scope"], values: Optional[dict] = None,
                 unset: frozenset = frozenset()):
        self.parent = parent
        self.vars = dict.fromkeys(unset, _UNSET)
        if values:
            self.vars.update(values)

    def lookup(self, name: str):
        s = self
        while s is not None:
            v = s.vars.get(name, _MISSING)
            if v is not _MISSING:
                return v
            s = s.parent
        return _GLOBALS.get(name, _MISSING)


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Node:
    __slots__ = ()
    #: child fields the post-parse checks walk, in order
    fields: tuple = ()

    def children(self):
        for f in self.fields:
            v = getattr(self, f)
            if isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, _Node):
                        yield f, x
                    elif isinstance(x, tuple):  # (key, value) pairs, (op, expr) operands
                        yield from ((f, y) for y in x if isinstance(y, _Node))
            elif isinstance(v, _Node):
                yield f, v


class Const(_Node):
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def ev(self, scope):
        return self.value


class Name(_Node):
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def ev(self, scope):
        v = scope.lookup(self.name)
        return Undefined(name=self.name) if v is _MISSING or v is _UNSET else v


class NSRef(_Node):
    __slots__ = ("name", "attr")

    def __init__(self, name, attr):
        self.name, self.attr = name, attr


class Getattr(_Node):
    __slots__ = ("node", "attr")
    fields = ("node",)

    def __init__(self, node, attr):
        self.node, self.attr = node, attr

    def ev(self, scope):
        return getattr_(self.node.ev(scope), self.attr)


class Slice(_Node):
    __slots__ = ("start", "stop", "step")
    fields = ("start", "stop", "step")

    def __init__(self, start, stop, step):
        self.start, self.stop, self.step = start, stop, step

    def ev(self, scope):
        return slice(*(None if x is None else x.ev(scope)
                       for x in (self.start, self.stop, self.step)))


class Getitem(_Node):
    __slots__ = ("node", "arg")
    fields = ("node", "arg")

    def __init__(self, node, arg):
        self.node, self.arg = node, arg

    def ev(self, scope):
        obj = self.node.ev(scope)
        if isinstance(self.arg, Slice):  # jinja2 compiles a slice to Python's
            return obj[self.arg.ev(scope)]
        return getitem(obj, self.arg.ev(scope))


def _call_args(node, scope):
    return [a.ev(scope) for a in node.args], {k: v.ev(scope) for k, v in node.kwargs}


class _Callish(_Node):
    __slots__ = ("node", "args", "kwargs")
    fields = ("node", "args", "kwargs")

    def __init__(self, node, args, kwargs):
        self.node, self.args, self.kwargs = node, args, kwargs


class Call(_Callish):
    __slots__ = ()

    def ev(self, scope):
        fn = self.node.ev(scope)
        args, kwargs = _call_args(self, scope)
        return fn(*args, **kwargs)


class Filter(_Callish):
    __slots__ = ("name",)

    def __init__(self, node, name, *rest):
        super().__init__(node, *rest)
        self.name = name

    def apply(self, value, scope):
        args, kwargs = _call_args(self, scope)
        return _call_filter(self.name, value, args, kwargs)

    def ev(self, scope):
        return self.apply(self.node.ev(scope), scope)


class Test(_Callish):
    __slots__ = ("name",)

    def __init__(self, node, name, *rest):
        super().__init__(node, *rest)
        self.name = name

    def ev(self, scope):
        value = self.node.ev(scope)
        args, kwargs = _call_args(self, scope)
        return _call_test(self.name, value, args, kwargs)


class CondExpr(_Node):
    __slots__ = ("test", "expr1", "expr2")
    fields = ("test", "expr1", "expr2")

    def __init__(self, test, expr1, expr2):
        self.test, self.expr1, self.expr2 = test, expr1, expr2

    def ev(self, scope):
        if self.test.ev(scope):
            return self.expr1.ev(scope)
        if self.expr2 is None:
            return Undefined("the inline if-expression evaluated to false and no else "
                             "section was defined.")
        return self.expr2.ev(scope)


_BINOPS = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
           "div": operator.truediv, "floordiv": operator.floordiv, "mod": operator.mod,
           "pow": operator.pow}
_COMPARE = {"eq": operator.eq, "ne": operator.ne, "lt": operator.lt, "lteq": operator.le,
            "gt": operator.gt, "gteq": operator.ge, "in": lambda a, b: a in b,
            "notin": lambda a, b: a not in b}


class BinOp(_Node):
    __slots__ = ("op", "left", "right")
    fields = ("left", "right")

    def __init__(self, op, left, right):
        self.op, self.left, self.right = op, left, right

    def ev(self, scope):
        left = self.left
        if self.op == "pow" and isinstance(left, Const) and type(left.value) in (int, float) \
                and str(left.value).startswith("-"):
            # jinja2 writes a negative constant base without parentheses,
            # so Python reads `-2 ** x` as -(2 ** x)
            return -(-left.value) ** self.right.ev(scope)
        return _BINOPS[self.op](left.ev(scope), self.right.ev(scope))


class Concat(_Node):
    __slots__ = ("nodes",)
    fields = ("nodes",)

    def __init__(self, nodes):
        self.nodes = nodes

    def ev(self, scope):
        return "".join(str(n.ev(scope)) for n in self.nodes)


class Compare(_Node):
    __slots__ = ("expr", "ops")
    fields = ("expr", "ops")

    def __init__(self, expr, ops):
        self.expr, self.ops = expr, ops

    def ev(self, scope):
        left = self.expr.ev(scope)
        result = True
        for op, node in self.ops:  # Python's chained comparison
            right = node.ev(scope)
            result = _COMPARE[op](left, right)
            if not result:
                return result
            left = right
        return result


class And(_Node):
    __slots__ = ("left", "right")
    fields = ("left", "right")

    def __init__(self, left, right):
        self.left, self.right = left, right

    def ev(self, scope):
        return self.left.ev(scope) and self.right.ev(scope)


class Or(And):
    __slots__ = ()

    def ev(self, scope):
        return self.left.ev(scope) or self.right.ev(scope)


class Unary(_Node):
    __slots__ = ("op", "node")
    fields = ("node",)

    def __init__(self, op, node):
        self.op, self.node = op, node

    def ev(self, scope):
        v = self.node.ev(scope)
        return not v if self.op == "not" else (-v if self.op == "sub" else +v)


class Seq(_Node):
    """A tuple, list or dict literal (`kind`); a dict's items are pairs."""

    __slots__ = ("kind", "items")
    fields = ("items",)

    def __init__(self, kind, items):
        self.kind, self.items = kind, items

    def ev(self, scope):
        if self.kind == "dict":
            return {k.ev(scope): v.ev(scope) for k, v in self.items}
        values = [x.ev(scope) for x in self.items]
        return tuple(values) if self.kind == "tuple" else values


# statements: run(scope, out)


def _run_body(body, scope, out):
    for node in body:
        node.run(scope, out)


def _assign(target, value, scope):
    if isinstance(target, Name):
        scope.vars[target.name] = value
    elif isinstance(target, NSRef):
        ns = scope.lookup(target.name)
        if not isinstance(ns, Namespace):
            raise TemplateError("cannot assign attribute on non-namespace object")
        ns.attrs[target.attr] = value
    else:  # a tuple target unpacks as Python does
        values = tuple(value)
        if len(values) != len(target.items):
            raise ValueError(f"expected {len(target.items)} values to unpack, got "
                             f"{len(values)}")
        for t, v in zip(target.items, values):
            _assign(t, v, scope)


class Output(_Node):
    __slots__ = ("nodes",)
    fields = ("nodes",)

    def __init__(self, nodes):
        self.nodes = nodes

    def run(self, scope, out):
        for n in self.nodes:
            out.append(n.value if isinstance(n, Const) and isinstance(n.value, str)
                       else str(n.ev(scope)))


class For(_Node):
    __slots__ = ("target", "iter", "body", "else_", "test", "unset", "else_unset")
    fields = ("iter", "test", "body", "else_")

    def __init__(self, target, iter, body, else_, test):
        self.target, self.iter, self.body, self.else_, self.test = target, iter, body, else_, test
        self.unset = self.else_unset = frozenset()

    def run(self, scope, out):
        items = list(self.iter.ev(scope))
        if self.test is not None:
            kept = []
            for item in items:
                s = _Scope(scope)
                _assign(self.target, item, s)
                if self.test.ev(s):
                    kept.append(item)
            items = kept
        # jinja2 clears its "no iteration" flag at the end of the body, so
        # `else` also runs when every iteration left by break or continue
        run_else = True
        loop = LoopContext(items)
        for item in items:
            loop.index0 += 1
            s = _Scope(scope, {"loop": loop}, self.unset)
            _assign(self.target, item, s)
            try:
                _run_body(self.body, s, out)
            except _Break:
                break
            except _Continue:
                continue
            run_else = False
        if run_else:
            _run_body(self.else_, _Scope(scope, None, self.else_unset), out)


class If(_Node):
    __slots__ = ("test", "body", "elif_", "else_")
    fields = ("test", "body", "elif_", "else_")

    def __init__(self, test, body, elif_, else_):
        self.test, self.body, self.elif_, self.else_ = test, body, elif_, else_

    def run(self, scope, out):
        if self.test.ev(scope):
            _run_body(self.body, scope, out)
            return
        for node in self.elif_:
            if node.test.ev(scope):
                _run_body(node.body, scope, out)
                return
        _run_body(self.else_, scope, out)


class Assign(_Node):
    __slots__ = ("target", "node")
    fields = ("node",)

    def __init__(self, target, node):
        self.target, self.node = target, node

    def run(self, scope, out):
        _assign(self.target, self.node.ev(scope), scope)


class AssignBlock(_Node):
    __slots__ = ("target", "filter", "body", "unset")
    fields = ("filter", "body")

    def __init__(self, target, filter, body):
        self.target, self.filter, self.body = target, filter, body
        self.unset = frozenset()

    def run(self, scope, out):
        inner = _Scope(scope, None, self.unset)
        buf: list = []
        _run_body(self.body, inner, buf)
        value = "".join(buf)
        if self.filter is not None:
            value = _apply_filters(self.filter, value, inner)
        _assign(self.target, value, scope)


def _apply_filters(node, value, scope):
    """A filter chain parsed with no operand (`set x | f | g`): applied
    innermost first."""
    if node is None:
        return value
    return node.apply(_apply_filters(node.node, value, scope), scope)


class Generation(_Node):
    """transformers' `{% generation %}` tag: a call block whose caller
    renders the body, in a frame of its own."""

    __slots__ = ("body", "unset")
    fields = ("body",)

    def __init__(self, body):
        self.body = body
        self.unset = frozenset()

    def run(self, scope, out):
        _run_body(self.body, _Scope(scope, None, self.unset), out)


class Break(_Node):
    __slots__ = ()

    def run(self, scope, out):
        raise _Break


class Continue(_Node):
    __slots__ = ()

    def run(self, scope, out):
        raise _Continue


# -- parser ---------------------------------------------------------------------------

_REFUSED_TAGS = ("macro", "call", "filter", "with", "print", "block", "extends", "include",
                 "import", "from", "autoescape")


class _Parser:
    """jinja2's Parser, trimmed to what the node set above can run."""

    def __init__(self, source: str):
        self.tokens = tokenize(source)
        self.i = 0
        self.loops = 0
        #: jinja2 constructs this subset lacks, by name, in order of reading
        self.unsupported: list = []

    # the token stream
    @property
    def cur(self):
        return self.tokens[self.i]

    def look(self):
        return self.tokens[min(self.i + 1, len(self.tokens) - 1)]

    def next(self):
        tok = self.tokens[self.i]
        if tok[0] != "eof":
            self.i += 1
        return tok

    def test(self, expr: str, tok=None) -> bool:
        tok = tok or self.cur
        if ":" in expr:
            kind, value = expr.split(":", 1)
            return tok[0] == kind and tok[1] == value
        return tok[0] == expr

    def skip_if(self, expr: str) -> bool:
        if self.test(expr):
            self.next()
            return True
        return False

    def expect(self, expr: str):
        if not self.test(expr):
            if self.cur[0] == "eof":
                raise TemplateSyntaxError(f"unexpected end of template, expected {expr!r}.")
            raise TemplateSyntaxError(f"expected token {expr!r}, got {self.cur[1]!r}")
        return self.next()

    # statements
    def parse(self) -> list:
        return self.subparse(None)

    def subparse(self, end_tokens) -> list:
        body: list = []
        data: list = []

        def flush():
            if data:
                body.append(Output(data[:]))
                del data[:]

        while self.cur[0] != "eof":
            kind, value = self.cur
            if kind == "data":
                data.append(Const(value))
                self.next()
            elif kind == "variable_begin":
                self.next()
                data.append(self.parse_tuple())
                self.expect("variable_end")
            elif kind == "block_begin":
                flush()
                self.next()
                if end_tokens is not None and any(self.test(t) for t in end_tokens):
                    return body
                body.append(self.parse_statement())
                self.expect("block_end")
            else:
                raise TemplateSyntaxError(f"unexpected {value!r}")
        flush()
        return body

    def parse_statements(self, end_tokens, drop_needle=False) -> list:
        self.skip_if("colon")
        self.expect("block_end")
        result = self.subparse(end_tokens)
        if self.cur[0] == "eof":
            raise TemplateSyntaxError(f"unexpected end of template, expected one of "
                                      f"{end_tokens}")
        if drop_needle:
            self.next()
        return result

    def parse_statement(self):
        kind, tag = self.cur
        if kind != "name":
            raise TemplateSyntaxError("tag name expected")
        if tag in _REFUSED_TAGS:
            raise _refused(f"{tag!r} tag")
        parse = {"for": self.parse_for, "if": self.parse_if, "set": self.parse_set,
                 "generation": self.parse_generation, "break": self.parse_loop_control,
                 "continue": self.parse_loop_control}.get(tag)
        if parse is None:
            raise TemplateSyntaxError(f"Encountered unknown tag {tag!r}.")
        return parse()

    def parse_loop_control(self):
        tag = self.next()[1]
        if not self.loops:
            raise TemplateSyntaxError(f"{tag!r} outside of a loop")
        return Break() if tag == "break" else Continue()

    def parse_generation(self):
        self.next()
        loops, self.loops = self.loops, 0
        body = self.parse_statements(("name:endgeneration",), drop_needle=True)
        self.loops = loops
        return Generation(body)

    def parse_set(self):
        self.next()
        target = self.parse_assign_target(with_namespace=True)
        if self.skip_if("assign"):
            return Assign(target, self.parse_tuple())
        filter_node = self.parse_filter(None)
        body = self.parse_statements(("name:endset",), drop_needle=True)
        return AssignBlock(target, filter_node, body)

    def parse_for(self):
        self.expect("name:for")
        target = self.parse_assign_target(extra_end_rules=("name:in",))
        self.expect("name:in")
        iter_ = self.parse_tuple(with_condexpr=False, extra_end_rules=("name:recursive",))
        test = self.parse_expression() if self.skip_if("name:if") else None
        if self.skip_if("name:recursive"):
            raise _refused("recursive for loop")
        self.loops += 1
        body = self.parse_statements(("name:endfor", "name:else"))
        self.loops -= 1
        if self.next()[1] == "endfor":
            else_ = []
        else:
            else_ = self.parse_statements(("name:endfor",), drop_needle=True)
        return For(target, iter_, body, else_, test)

    def parse_if(self):
        self.expect("name:if")
        node = result = If(None, [], [], [])
        while True:
            node.test = self.parse_tuple(with_condexpr=False)
            node.body = self.parse_statements(("name:elif", "name:else", "name:endif"))
            tok = self.next()
            if self.test("name:elif", tok):
                node = If(None, [], [], [])
                result.elif_.append(node)
                continue
            if self.test("name:else", tok):
                result.else_ = self.parse_statements(("name:endif",), drop_needle=True)
            break
        return result

    def parse_assign_target(self, extra_end_rules=None, with_namespace=False):
        target = self.parse_tuple(simplified=True, extra_end_rules=extra_end_rules,
                                  with_namespace=with_namespace)
        if not _can_assign(target):
            raise TemplateSyntaxError(f"can't assign to {type(target).__name__.lower()!r}")
        return target

    # expressions
    def parse_expression(self, with_condexpr=True):
        return self.parse_condexpr() if with_condexpr else self.parse_or()

    def parse_condexpr(self):
        expr1 = self.parse_or()
        while self.skip_if("name:if"):
            expr2 = self.parse_or()
            expr3 = self.parse_condexpr() if self.skip_if("name:else") else None
            expr1 = CondExpr(expr2, expr1, expr3)
        return expr1

    def parse_or(self):
        left = self.parse_and()
        while self.skip_if("name:or"):
            left = Or(left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.skip_if("name:and"):
            left = And(left, self.parse_not())
        return left

    def parse_not(self):
        if self.test("name:not"):
            self.next()
            return Unary("not", self.parse_not())
        return self.parse_compare()

    def parse_compare(self):
        expr = self.parse_math1()
        ops = []
        while True:
            kind = self.cur[0]
            if kind in ("eq", "ne", "lt", "lteq", "gt", "gteq"):
                self.next()
                ops.append((kind, self.parse_math1()))
            elif self.skip_if("name:in"):
                ops.append(("in", self.parse_math1()))
            elif self.test("name:not") and self.test("name:in", self.look()):
                self.next()
                self.next()
                ops.append(("notin", self.parse_math1()))
            else:
                break
        return Compare(expr, ops) if ops else expr

    def parse_math1(self):
        left = self.parse_concat()
        while self.cur[0] in ("add", "sub"):
            op = self.next()[0]
            left = BinOp(op, left, self.parse_concat())
        return left

    def parse_concat(self):
        args = [self.parse_math2()]
        while self.cur[0] == "tilde":
            self.next()
            args.append(self.parse_math2())
        return args[0] if len(args) == 1 else Concat(args)

    def parse_math2(self):
        left = self.parse_pow()
        while self.cur[0] in ("mul", "div", "floordiv", "mod"):
            op = self.next()[0]
            left = BinOp(op, left, self.parse_pow())
        return left

    def parse_pow(self):
        left = self.parse_unary()
        while self.cur[0] == "pow":
            self.next()
            left = BinOp("pow", left, self.parse_unary())
        return left

    def parse_unary(self, with_filter=True):
        kind = self.cur[0]
        if kind in ("sub", "add"):
            self.next()
            node = Unary(kind, self.parse_unary(False))
        else:
            node = self.parse_primary()
        node = self.parse_postfix(node)
        if with_filter:
            node = self.parse_filter_expr(node)
        return node

    def parse_primary(self, with_namespace=False):
        kind, value = self.cur
        if kind == "name":
            self.next()
            if value in ("true", "false", "True", "False"):
                return Const(value in ("true", "True"))
            if value in ("none", "None"):
                return Const(None)
            if with_namespace and self.cur[0] == "dot":
                self.next()
                return NSRef(value, self.expect("name")[1])
            if value in JINJA_GLOBALS and value not in _GLOBALS:
                self.unsupported.append(f"global {value!r}")
            return Name(value)
        if kind == "string":
            buf = []
            while self.cur[0] == "string":
                buf.append(self.next()[1])
            return Const("".join(buf))
        if kind in ("integer", "float"):
            self.next()
            return Const(value)
        if kind == "lparen":
            self.next()
            node = self.parse_tuple(explicit_parentheses=True)
            self.expect("rparen")
            return node
        if kind == "lbracket":
            return self.parse_list()
        if kind == "lbrace":
            return self.parse_dict()
        raise TemplateSyntaxError(f"unexpected {value or kind!r}")

    def parse_tuple(self, simplified=False, with_condexpr=True, extra_end_rules=None,
                    explicit_parentheses=False, with_namespace=False):
        args = []
        is_tuple = False
        while True:
            if args:
                self.expect("comma")
            if self.cur[0] in ("variable_end", "block_end", "rparen") or (
                    extra_end_rules and any(self.test(r) for r in extra_end_rules)):
                break
            args.append(self.parse_primary(with_namespace) if simplified
                        else self.parse_expression(with_condexpr))
            if self.cur[0] == "comma":
                is_tuple = True
            else:
                break
        if not is_tuple:
            if args:
                return args[0]
            if not explicit_parentheses:
                raise TemplateSyntaxError(f"Expected an expression, got {self.cur[1]!r}")
        return Seq("tuple", args)

    def parse_list(self):
        self.expect("lbracket")
        items = []
        while self.cur[0] != "rbracket":
            if items:
                self.expect("comma")
            if self.cur[0] == "rbracket":
                break
            items.append(self.parse_expression())
        self.expect("rbracket")
        return Seq("list", items)

    def parse_dict(self):
        self.expect("lbrace")
        items = []
        while self.cur[0] != "rbrace":
            if items:
                self.expect("comma")
            if self.cur[0] == "rbrace":
                break
            key = self.parse_expression()
            self.expect("colon")
            items.append((key, self.parse_expression()))
        self.expect("rbrace")
        return Seq("dict", items)

    def parse_postfix(self, node):
        while True:
            kind = self.cur[0]
            if kind in ("dot", "lbracket"):
                node = self.parse_subscript(node)
            elif kind == "lparen":
                node = self.parse_call(node)
            else:
                return node

    def parse_filter_expr(self, node):
        while True:
            if self.cur[0] == "pipe":
                node = self.parse_filter(node)
            elif self.test("name:is"):
                node = self.parse_test(node)
            elif self.cur[0] == "lparen":
                node = self.parse_call(node)
            else:
                return node

    def parse_subscript(self, node):
        kind = self.next()[0]
        if kind == "dot":
            attr_kind, attr = self.next()
            if attr_kind == "name":
                return Getattr(node, attr)
            if attr_kind != "integer":
                raise TemplateSyntaxError("expected name or number")
            return Getitem(node, Const(attr))
        args = []
        while self.cur[0] != "rbracket":
            if args:
                self.expect("comma")
            args.append(self.parse_subscribed())
        self.expect("rbracket")
        return Getitem(node, args[0] if len(args) == 1 else Seq("tuple", args))

    def parse_subscribed(self):
        if self.cur[0] == "colon":
            self.next()
            args = [None]
        else:
            node = self.parse_expression()
            if self.cur[0] != "colon":
                return node
            self.next()
            args = [node]
        if self.cur[0] == "colon":
            args.append(None)
        elif self.cur[0] not in ("rbracket", "comma"):
            args.append(self.parse_expression())
        else:
            args.append(None)
        if self.cur[0] == "colon":
            self.next()
            args.append(self.parse_expression() if self.cur[0] not in ("rbracket", "comma")
                        else None)
        else:
            args.append(None)
        return Slice(*args)

    def parse_call_args(self):
        self.expect("lparen")
        args, kwargs = [], []
        require_comma = False
        while self.cur[0] != "rparen":
            if require_comma:
                self.expect("comma")
                if self.cur[0] == "rparen":
                    break
            if self.cur[0] in ("mul", "pow"):  # parsed on, and refused after the checks
                self.unsupported.append("*args" if self.next()[0] == "mul" else "**kwargs")
                self.parse_expression()
            elif self.cur[0] == "name" and self.look()[0] == "assign":
                key = self.next()[1]
                self.next()
                kwargs.append((key, self.parse_expression()))
            else:
                if kwargs:
                    raise TemplateSyntaxError("invalid syntax for function call expression")
                args.append(self.parse_expression())
            require_comma = True
        self.expect("rparen")
        return args, kwargs

    def parse_call(self, node):
        return Call(node, *self.parse_call_args())

    def _dotted_name(self):
        name = self.expect("name")[1]
        while self.cur[0] == "dot":
            self.next()
            name += "." + self.expect("name")[1]
        return name

    def parse_filter(self, node):
        while self.cur[0] == "pipe":
            self.next()
            name = self._dotted_name()
            if name in JINJA_FILTERS and name not in FILTERS:
                self.unsupported.append(f"filter {name!r}")
            call = self.parse_call_args() if self.cur[0] == "lparen" else ([], [])
            node = Filter(node, name, *call)
        return node

    def parse_test(self, node):
        self.next()
        negated = self.skip_if("name:not")
        name = self._dotted_name()
        if name in JINJA_TESTS and name not in TESTS:
            self.unsupported.append(f"test {name!r}")
        call = ([], [])
        if self.cur[0] == "lparen":
            call = self.parse_call_args()
        elif self.cur[0] in ("name", "string", "integer", "float", "lparen", "lbracket",
                             "lbrace") and not any(
                self.test(t) for t in ("name:else", "name:or", "name:and")):
            if self.test("name:is"):
                raise TemplateSyntaxError("You cannot chain multiple tests with is")
            call = ([self.parse_postfix(self.parse_primary())], [])
        node = Test(node, name, *call)
        return Unary("not", node) if negated else node


def _can_assign(node) -> bool:
    if isinstance(node, (Name, NSRef)):
        return True
    return isinstance(node, Seq) and node.kind == "tuple" and all(
        _can_assign(x) for x in node.items)


class _Impossible(Exception):
    """An expression jinja2's compiler cannot fold to a constant."""


#: jinja2's filters that take the render context, which it never folds
_CONTEXT_FILTERS = frozenset(("reject",))


def _fold(node):
    """jinja2's `as_const`: the value an expression of literals has at
    compile time, or _Impossible. A folded slice goes through the
    sandbox's getitem (an unsliceable literal gives Undefined), and `and`,
    `or` and the conditional fold only the operands they reach."""
    t = type(node)
    if t is Const:
        return node.value
    if t is Seq:
        if node.kind == "dict":
            return dict((_fold(k), _fold(v)) for k, v in node.items)
        values = [_fold(x) for x in node.items]
        return tuple(values) if node.kind == "tuple" else values
    if t is Slice:
        return slice(*(None if x is None else _fold(x) for x in (node.start, node.stop,
                                                                node.step)))
    if t is And:
        return _fold(node.left) and _fold(node.right)
    if t is Or:
        return _fold(node.left) or _fold(node.right)
    if t is CondExpr:
        if _fold(node.test):
            return _fold(node.expr1)
        if node.expr2 is None:
            raise _Impossible
        return _fold(node.expr2)
    if t is Concat:
        return "".join(str(_fold(n)) for n in node.nodes)
    if t in (Filter, Test):
        table = FILTERS if t is Filter else TESTS
        if node.node is None or node.name not in table or node.name in _CONTEXT_FILTERS:
            raise _Impossible
        args = [_fold(a) for a in node.args]
        kwargs = {k: _fold(v) for k, v in node.kwargs}
    operands = {Unary: lambda: (node.node,), BinOp: lambda: (node.left, node.right),
                Getattr: lambda: (node.node,), Getitem: lambda: (node.node, node.arg),
                Compare: lambda: (node.expr,), Filter: lambda: (node.node,),
                Test: lambda: (node.node,)}.get(t)
    if operands is None:  # a name, a call
        raise _Impossible
    values = [_fold(x) for x in operands()]
    try:
        if t is Compare:
            value, result = values[0], True
            for op, expr in node.ops:
                new = _fold(expr)
                result = _COMPARE[op](value, new)
                if not result:
                    return False
                value = new
            return result
        if t in (Filter, Test):
            return table[node.name](values[0], *args, **kwargs)
        if t is Unary:
            return Unary(node.op, Const(values[0])).ev(None)
        if t is BinOp:
            return _BINOPS[node.op](*values)
        if t is Getattr:
            return getattr_(values[0], node.attr)
        return getitem(*values)
    except Exception as e:
        raise _Impossible from e


def _safe_repr(value) -> bool:
    """jinja2's has_safe_repr: what its optimizer may write as a constant."""
    if value is None or type(value) in (bool, int, float, complex, range, str):
        return True
    if type(value) in (tuple, list, set, frozenset):
        return all(_safe_repr(v) for v in value)
    if type(value) is dict:
        return all(_safe_repr(k) and _safe_repr(v) for k, v in value.items())
    return False


def _optimize(node):
    """jinja2's optimizer, bottom-up: an expression whose folded value has a
    safe repr becomes a Const (what is folded away, an unknown filter
    included, is never compiled); an output's expression that folds at all
    prints its folded value."""
    for f in node.fields:
        v = getattr(node, f)
        if isinstance(v, _Node):
            setattr(node, f, _optimize(v))
        elif isinstance(v, list):
            setattr(node, f, [
                _optimize(x) if isinstance(x, _Node) else
                tuple(_optimize(y) if isinstance(y, _Node) else y for y in x)
                if isinstance(x, tuple) else x for x in v])
    if isinstance(node, Output):
        node.nodes = [_fold_output(n) for n in node.nodes]
    elif hasattr(node, "ev") and not isinstance(node, Const):
        try:
            value = _fold(node)
        except _Impossible:
            return node
        if _safe_repr(value):
            return Const(value)
    return node


def _fold_output(node):
    if isinstance(node, Const):
        return node
    try:
        return Const(str(_fold(node)))
    except Exception:
        return _optimize(node)


def _target_names(target) -> list:
    """The names an assignment target binds (a namespace attribute binds
    none)."""
    if isinstance(target, Name):
        return [target.name]
    if isinstance(target, Seq):
        return [n for t in target.items for n in _target_names(t)]
    return []


class _Symbols:
    """One frame's symbol table (jinja2's idtracking.Symbols): name -> how
    the frame's variable starts: "param", "resolve" (from the context),
    "alias" (an enclosing frame's) or "unset"."""

    def __init__(self, outer: frozenset):
        self.outer = outer  # names the enclosing frames reference
        self.refs: dict = {}
        self.stores: set = set()

    def copy(self) -> "_Symbols":
        rv = _Symbols(self.outer)
        rv.refs, rv.stores = dict(self.refs), set(self.stores)
        return rv

    def load(self, name):
        if name not in self.refs and name not in self.outer:
            self.refs[name] = "resolve"

    def store(self, name):
        self.stores.add(name)
        if name not in self.refs:
            self.refs[name] = "alias" if name in self.outer else "unset"

    def param(self, name):
        self.stores.add(name)
        self.refs[name] = "param"

    def visit(self, x):
        """jinja2's FrameSymbolVisitor: what this frame's own nodes read and
        bind (a nested frame's body is its own)."""
        if isinstance(x, (Name, NSRef)):
            self.load(x.name)
        elif isinstance(x, If):
            self.visit(x.test)
            branches = []
            for nodes in (x.body, x.elif_, x.else_):
                branch = self.copy()
                for n in nodes:
                    branch.visit(n)
                branches.append(branch)
            # a name bound in a branch starts from the context or the
            # enclosing frame, however many branches bind it
            stored = set().union(*(b.stores for b in branches)) - self.stores
            for b in branches:
                self.refs.update(b.refs)
                self.stores |= b.stores
            for name in stored:
                self.refs[name] = "alias" if name in self.outer else "resolve"
        elif isinstance(x, (Assign, AssignBlock)):
            if isinstance(x, Assign):
                self.visit(x.node)
            if isinstance(x.target, NSRef):
                self.load(x.target.name)
            for name in _target_names(x.target):
                self.store(name)
        elif isinstance(x, For):
            self.visit(x.iter)
        elif not isinstance(x, (Generation, Break, Continue)):
            for _, child in x.children():
                self.visit(child)


def _frame(outer: frozenset, nodes: list, params=()) -> tuple:
    """A frame's unset names and the names it and its enclosing frames
    reference, after jinja2's RootVisitor; its nested frames annotated."""
    sym = _Symbols(outer)
    for name in params:
        sym.param(name)
    for node in nodes:
        sym.visit(node)
    inner = outer | frozenset(sym.refs)
    _annotate(nodes, inner)
    return frozenset(n for n, how in sym.refs.items() if how == "unset"), inner


def _annotate(nodes: list, outer: frozenset) -> None:
    """Give each frame nested in `nodes` (a for body and else, generation
    and block-set bodies) its unset names."""
    for node in nodes:
        if isinstance(node, If):
            for branch in (node.body, *(e.body for e in node.elif_), node.else_):
                _annotate(branch, outer)
        elif isinstance(node, For):
            node.unset = _frame(outer, node.body, _target_names(node.target))[0]
            node.else_unset = _frame(outer, node.else_)[0]
        elif isinstance(node, (AssignBlock, Generation)):
            node.unset = _frame(outer, node.body)[0]


def _check_names(body: list, soft: bool = False) -> None:
    """jinja2's compile-time check: a filter or test jinja2 does not have is
    an error, except inside an `if` or a conditional expression, where
    jinja2 raises only when it is called."""
    for node in body:
        if isinstance(node, (Filter, Test)):
            known = JINJA_FILTERS if isinstance(node, Filter) else JINJA_TESTS
            if node.name not in known and not soft:
                kind = "filter" if isinstance(node, Filter) else "test"
                raise TemplateSyntaxError(f"No {kind} named {node.name!r}.")
        if isinstance(node, If):
            for branch in [node, *node.elif_]:
                _check_names([branch.test], True)
                _check_names(branch.body, True)
            _check_names(node.else_, True)
        elif isinstance(node, CondExpr):
            _check_names([n for _, n in node.children()], True)
        elif isinstance(node, For):
            _check_names([node.iter], soft)
            _check_names([n for n in (node.test,) if n is not None] + node.body + node.else_)
        elif isinstance(node, Generation):
            _check_names(node.body)
        elif isinstance(node, AssignBlock):
            _check_names(([node.filter] if node.filter is not None else []) + node.body)
        else:
            _check_names([n for _, n in node.children()], soft)


class ChatTemplate:
    """A chat template parsed once, rendered per request.

    `render(**context)` raises `NotImplementedError` (naming the
    construct) when the template uses a construct of jinja2 this subset
    lacks, held from the parse; `TemplateError` or the Python error jinja2
    would raise when jinja2 fails on the template or the context."""

    def __init__(self, source: str):
        self.source = source
        self._body: Optional[list] = None
        self._error: Optional[Exception] = None
        try:
            parser = _Parser(source)
            body = [_optimize(node) for node in parser.parse()]
            _check_names(body)  # jinja2's own failure comes before a refusal
            if parser.unsupported:
                raise _refused(parser.unsupported[0])
            self._unset = _frame(frozenset(), body)[0]
            self._body = body
        except (TemplateError, NotImplementedError) as e:
            self._error = e

    @property
    def refusal(self) -> Optional[NotImplementedError]:
        """The construct this subset lacks, if the template uses one."""
        return self._error if isinstance(self._error, NotImplementedError) else None

    def render(self, **context) -> str:
        if self._error is not None:
            raise type(self._error)(*self._error.args)
        out: list = []
        _run_body(self._body, _Scope(_Scope(None, context), None, self._unset), out)
        return "".join(out)
