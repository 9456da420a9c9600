"""A YAML reader and writer for the subset the repository's configs use.

The machine with the card has no PyYAML.  ``loads`` reads block mappings,
block sequences (sequences of mappings included), flow lists and mappings
(nested), comments and quoted strings, and resolves plain scalars as
PyYAML's ``safe_load`` does (YAML 1.1): ``1e-3`` is a string while
``1.0e-3`` is a float, ``yes`` / ``no`` / ``on`` / ``off`` are booleans,
``~`` and ``null`` are None, ``010`` is octal, ``1:30`` is sexagesimal.
Anything outside the subset (anchors, aliases, tags, directives, several
documents, block scalars ``|`` / ``>``, multi-line plain scalars, complex
keys, timestamps) raises ``YAMLError`` naming the line: nothing is misread
silently.

``dumps`` writes nested dicts, lists and scalars so that both ``loads`` and
PyYAML read them back equal.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Optional, Tuple


class YAMLError(ValueError):
    """Text outside the supported subset, or malformed."""


_BOOL = {v: b for b, vs in ((True, "yes Yes YES true True TRUE on On ON"),
                            (False, "no No NO false False FALSE off Off OFF"))
         for v in vs.split()}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_RESERVED = "@`%&*!|>"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, conv):
    value = 0
    for part in text.split(":"):
        value = value * 60 + conv(part)
    return value


def resolve_plain(text: str, line: int = 0) -> Any:
    """A plain (unquoted) scalar as PyYAML's SafeLoader resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP.match(text):
        raise YAMLError(f"line {line}: timestamp {text!r} is outside the "
                        "supported subset")
    if text in ("=", "<<"):
        raise YAMLError(f"line {line}: {text!r} (value / merge key) is "
                        "outside the supported subset")
    return text


# ---------------------------------------------------------------------------
# scanning
# ---------------------------------------------------------------------------


def _strip_comment(text: str) -> str:
    """The line without its comment; quotes are respected."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t[{,:-?"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _quoted(text: str, i: int, lineno: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i]; returns (value, index after)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'":
            if c == "'":
                if j + 1 < len(text) and text[j + 1] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(c)
        else:
            if c == '"':
                return "".join(out), j + 1
            if c == "\\":
                j += 1
                e = text[j] if j < len(text) else ""
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    code = text[j + 1:j + 1 + n]
                    if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+",
                                                          code):
                        raise YAMLError(f"line {lineno}: bad escape "
                                        f"\\{e}{code}")
                    out.append(chr(int(code, 16)))
                    j += n
                else:
                    raise YAMLError(f"line {lineno}: unknown escape \\{e}")
            else:
                out.append(c)
        j += 1
    raise YAMLError(f"line {lineno}: unterminated quoted scalar (multi-line "
                    "quoted scalars are outside the supported subset)")


def _check_plain(text: str, lineno: int) -> None:
    if not text:
        return
    if text[0] in _RESERVED:
        raise YAMLError(f"line {lineno}: {text!r} starts with {text[0]!r} "
                        "(anchor, alias, tag, directive or block scalar), "
                        "outside the supported subset")
    if text[0] == "?" and (len(text) == 1 or text[1] == " "):
        raise YAMLError(f"line {lineno}: complex keys are outside the "
                        "supported subset")
    if text == "-" or text.startswith("- "):
        raise YAMLError(f"line {lineno}: a sequence entry is not allowed "
                        f"here: {text!r}")


class _Flow:
    """A flow collection or scalar: [..], {..}, quoted or plain."""

    def __init__(self, text: str, lineno: int):
        self.text, self.lineno, self.i = text, lineno, 0

    def error(self, what: str):
        return YAMLError(f"line {self.lineno}: {what} in flow text "
                         f"{self.text!r}")

    def skip(self):
        while self.i < len(self.text) and self.text[self.i] in " \t\n":
            self.i += 1

    def parse(self) -> Any:
        self.skip()
        value = self.node()
        self.skip()
        if self.i != len(self.text):
            raise self.error(f"unexpected {self.text[self.i:]!r}")
        return value

    def node(self) -> Any:
        self.skip()
        if self.i >= len(self.text):
            return None
        c = self.text[self.i]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in "'\"":
            value, self.i = _quoted(self.text, self.i, self.lineno)
            return value
        start = self.i
        while self.i < len(self.text):
            c = self.text[self.i]
            if c in ",]}":
                break
            if c == ":" and (self.i + 1 == len(self.text)
                             or self.text[self.i + 1] in " ,]}"):
                break
            if c in "[{":
                raise self.error(f"{c!r} inside a plain scalar")
            self.i += 1
        plain = self.text[start:self.i].strip()
        _check_plain(plain, self.lineno)
        return resolve_plain(plain, self.lineno)

    def seq(self) -> List[Any]:
        self.i += 1
        out: List[Any] = []
        while True:
            self.skip()
            if self.i >= len(self.text):
                raise self.error("unterminated '['")
            if self.text[self.i] == "]":
                self.i += 1
                return out
            item = self.node()
            self.skip()
            if self.i < len(self.text) and self.text[self.i] == ":":
                raise self.error("a mapping inside a flow sequence")
            out.append(item)
            self.skip()
            if self.i < len(self.text) and self.text[self.i] == ",":
                self.i += 1
            elif self.i >= len(self.text) or self.text[self.i] != "]":
                raise self.error("expected ',' or ']'")

    def mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip()
            if self.i >= len(self.text):
                raise self.error("unterminated '{'")
            if self.text[self.i] == "}":
                self.i += 1
                return out
            key = self.node()
            self.skip()
            value = None
            if self.i < len(self.text) and self.text[self.i] == ":":
                self.i += 1
                value = self.node()
            _check_key(key, self.lineno)
            out[key] = value
            self.skip()
            if self.i < len(self.text) and self.text[self.i] == ",":
                self.i += 1
            elif self.i >= len(self.text) or self.text[self.i] != "}":
                raise self.error("expected ',' or '}'")


def _check_key(key: Any, lineno: int) -> None:
    if isinstance(key, (list, dict)):
        raise YAMLError(f"line {lineno}: a collection as a mapping key is "
                        "outside the supported subset")


def _split_key(text: str, lineno: int) -> Optional[Tuple[Any, str]]:
    """(key, rest) if ``text`` is ``key: value`` (or ``key:``), else None."""
    if not text or text[0] in "[{":
        return None
    if text[0] in "'\"":
        key, j = _quoted(text, 0, lineno)
        rest = text[j:].lstrip(" ")
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:].strip()
        return None
    for m in re.finditer(r":(?=\s|$)", text):
        key = text[:m.start()].rstrip()
        _check_plain(key, lineno)
        return resolve_plain(key, lineno), text[m.end():].strip()
    return None


class _Block:
    def __init__(self, source: str):
        self.lines: List[Tuple[int, int, str]] = []  # (lineno, indent, text)
        docs = 0
        for n, raw in enumerate(source.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLError(f"line {n}: tab in indentation")
            text = _strip_comment(raw)
            if not text.strip():
                continue
            if text.startswith("%"):
                raise YAMLError(f"line {n}: directives are outside the "
                                "supported subset")
            if text.rstrip() in ("---", "...") or text.startswith("--- "):
                if text.rstrip() == "..." or docs or self.lines:
                    raise YAMLError(f"line {n}: several documents are "
                                    "outside the supported subset")
                docs += 1
                text = text[3:]
                if not text.strip():
                    continue
            indent = len(text) - len(text.lstrip(" "))
            self.lines.append((n, indent, text.strip()))
        self.pos = 0

    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node()
        if self.pos < len(self.lines):
            n, _, text = self.lines[self.pos]
            raise YAMLError(f"line {n}: unexpected {text!r} (bad "
                            "indentation?)")
        return value

    def node(self) -> Any:
        """The block node starting at the current line."""
        n, ind, text = self.peek()
        if text == "-" or text.startswith("- "):
            return self.sequence(ind)
        if _split_key(text, n) is not None:
            return self.mapping(ind)
        self.pos += 1
        return self.scalar(text, n, ind)

    def scalar(self, text: str, n: int, indent: int) -> Any:
        """A one-line scalar or flow collection (flow text may continue on
        deeper lines until its brackets close)."""
        if text[0] in "[{":
            parts = [text]
            while _depth(" ".join(parts)) > 0 and self.peek() is not None:
                parts.append(self.lines[self.pos][2])
                self.pos += 1
            return _Flow(" ".join(parts), n).parse()
        if text[0] not in "'\"":
            _check_plain(text, n)
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent:
            raise YAMLError(f"line {nxt[0]}: multi-line scalars are "
                            "outside the supported subset")
        if text[0] in "'\"":
            value, j = _quoted(text, 0, n)
            if text[j:].strip():
                raise YAMLError(f"line {n}: text after a quoted scalar: "
                                f"{text[j:]!r}")
            return value
        if ": " in text or text.endswith(":"):
            raise YAMLError(f"line {n}: unexpected mapping in {text!r}")
        return resolve_plain(text, n)

    def value(self, rest: str, n: int, indent: int):
        """The value after ``key:`` on line n of a mapping at ``indent``."""
        if rest:
            return self.scalar(rest, n, indent)
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt[1] > indent:
            return self.node()
        # a sequence may sit at its key's own indent
        if nxt[1] == indent and (
                nxt[2] == "-" or nxt[2].startswith("- ")):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line[1] < indent:
                return out
            n, ind, text = line
            if ind > indent:
                raise YAMLError(f"line {n}: unexpected indentation")
            split = _split_key(text, n)
            if split is None:
                if text == "-" or text.startswith("- "):
                    return out  # the enclosing sequence's next item
                raise YAMLError(f"line {n}: expected 'key: value', got "
                                f"{text!r}")
            key, rest = split
            _check_key(key, n)
            self.pos += 1
            out[key] = self.value(rest, n, indent)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line[1] != indent:
                return out
            n, ind, text = line
            if not (text == "-" or text.startswith("- ")):
                return out
            content = text[1:].lstrip(" ")
            if not content:
                self.pos += 1
                nxt = self.peek()
                out.append(self.node() if nxt is not None
                           and nxt[1] > indent else None)
                continue
            # the item's content starts a node at its own column
            col = ind + (len(text) - len(content))
            self.lines[self.pos] = (n, col, content)
            if content == "-" or content.startswith("- "):
                out.append(self.sequence(col))
            elif _split_key(content, n) is not None:
                out.append(self.mapping(col))
            else:
                self.pos += 1
                out.append(self.scalar(content, n, col))


def _depth(text: str) -> int:
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
    return depth


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset."""
    return _Block(text).document()


def load(path) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"^[A-Za-z_/.][A-Za-z0-9_./()+-]*$")


def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)  # 1e-05 reads as a string
        return text
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v):
            try:
                if resolve_plain(v) == v:
                    return v
            except YAMLError:
                pass
        return json.dumps(v, ensure_ascii=False)
    raise YAMLError(f"cannot write {type(v).__name__} {v!r}")


def _is_flow(v: Any) -> bool:
    return not isinstance(v, dict) and (
        not isinstance(v, (list, tuple)) or all(_is_flow(x) for x in v))


def _flow(v: Any) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def _dump(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar(k)
            if isinstance(x, dict) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent + 2, out)
            elif isinstance(x, (list, tuple)) and x and not _is_flow(x):
                out.append(f"{pad}{key}:")
                _dump(x, indent + 2, out)
            elif isinstance(x, dict):
                out.append(f"{pad}{key}: {{}}")
            else:
                out.append(f"{pad}{key}: {_flow(x)}")
        return
    for x in v:  # a block sequence
        if isinstance(x, dict) and x:
            sub: List[str] = []
            _dump(x, indent + 2, sub)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out.extend(sub[1:])
        elif isinstance(x, dict):
            out.append(f"{pad}- {{}}")
        else:
            if not _is_flow(x):
                raise YAMLError("a list of lists holding mappings cannot be "
                                "written")
            out.append(f"{pad}- {_flow(x)}")


def dumps(data: Any) -> str:
    """YAML text that ``loads`` and PyYAML read back equal to ``data``
    (dicts, lists, tuples as lists, str, int, float, bool, None)."""
    if isinstance(data, dict) and data:
        out: List[str] = []
        _dump(data, 0, out)
        return "\n".join(out) + "\n"
    if isinstance(data, (list, tuple)) and data and not _is_flow(data):
        out = []
        _dump(data, 0, out)
        return "\n".join(out) + "\n"
    if isinstance(data, dict):
        return "{}\n"
    return _flow(data) + "\n"
