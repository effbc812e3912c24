"""A reader and a writer for the YAML of ``configs/**`` and of the files the
entry points write (an experiment's ``config.yaml``, the results, the
storer's metadata).

This module is no feature that the JAX package lacks: it stands in for
PyYAML, which the card's machine does not have.  The JAX package reads and
writes the same files with ``yaml.safe_load`` and ``yaml.safe_dump``; ``load``
reads what those write, to the same Python values, and ``dump`` writes what
they read back equal.

The subset:

* block mappings and block sequences, with the indentless sequence under a
  key and the compact ``- key: value`` and ``- - item`` forms that
  ``safe_dump`` writes;
* flow sequences on one line, of plain, ``'…'`` and ``"…"`` scalars and
  flow sequences, and the empty flow mapping ``{}``;
* full-line and trailing comments, empty values (null);
* the plain-scalar resolution of ``safe_load`` (YAML 1.1): ``null``, ``~``
  and the empty value; the booleans ``true/false/yes/no/on/off`` in their
  lower, capitalised and upper cases; ints (decimal, ``0b``, ``0x``, octal
  with a leading 0, base 60, ``_`` separators); floats with a dot (``1.e-3``,
  ``0.5e-2`` and ``0.`` are floats, while ``1e-3``, without a dot, stays a
  string, exactly as in PyYAML), ``.inf`` and ``.nan``.

Anything outside it (anchors and aliases, tags, block and multi-line
scalars, flow mappings with entries, complex keys, several documents,
directives, tabs as indentation, timestamps) raises ``YAMLError`` with its
line number: it is never guessed.
"""
from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLError", "dump", "load", "read", "write"]


class YAMLError(ValueError):
    def __init__(self, message: str, line: Optional[int] = None):
        super().__init__(f"line {line}: {message}" if line is not None else message)
        self.line = line


# ---- plain-scalar resolution (PyYAML's resolver.py and constructor.py) ------------

_BOOL = {word: value for value, words in ((True, ("yes", "true", "on")),
                                          (False, ("no", "false", "off")))
         for w in words for word in (w, w.capitalize(), w.upper())}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)""", re.X)
_FLOAT = re.compile(r"""(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))""", re.X)
_TIMESTAMP = re.compile(r"""(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[\ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)""", re.X)


def _sexagesimal(text: str, cast):
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def resolve_plain(text: str, line: Optional[int] = None) -> Any:
    """A plain scalar's value as ``safe_load`` constructs it."""
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.fullmatch(text):
        return _float(text)
    if _INT.fullmatch(text):
        return _int(text)
    if text == "<<":
        raise YAMLError("merge keys (<<) are not supported", line)
    if text in _NULL:
        return None
    if _TIMESTAMP.fullmatch(text):
        raise YAMLError(f"timestamps are not supported: {text!r}", line)
    if text == "=":
        raise YAMLError("the value key (=) is not supported", line)
    return text


# ---- reader ---------------------------------------------------------------------

_SPACE = " \t"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith(("- ", "-\t"))


def _blank_or_comment(rest: str) -> bool:
    stripped = rest.lstrip(_SPACE)
    return not stripped or (stripped[0] == "#" and (len(stripped) < len(rest) or not rest))


class _Reader:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        ended = None  # the line of a document end marker
        for number, raw in enumerate(text.splitlines(), start=1):
            body = raw.lstrip(" ")
            indent = len(raw) - len(body)
            if body.startswith("\t") and body.strip(_SPACE) and not body.lstrip(_SPACE).startswith("#"):
                raise YAMLError("tabs are not allowed as indentation", number)
            if not body.strip(_SPACE) or body.lstrip(_SPACE).startswith("#"):
                continue
            if ended is not None:
                raise YAMLError("several documents are not supported", number)
            if indent == 0 and re.match(r"\.\.\.(\s|$)", body) and _blank_or_comment(body[3:]):
                ended = number  # the end marker safe_dump writes after a lone scalar
                continue
            if indent == 0 and (body.startswith("%") or re.match(r"---(\s|$)", body)):
                raise YAMLError("directives and document markers are not supported", number)
            self.lines.append((number, indent, body.rstrip(_SPACE)))
        self.i = 0

    # -- nodes --
    def document(self) -> Any:
        if not self.lines:
            return None
        node = self.block(self.lines[0][1], parent=-1)
        if self.i < len(self.lines):
            raise YAMLError("unexpected content after the document's node", self.lines[self.i][0])
        return node

    def block(self, indent: int, parent: int) -> Any:
        number, _, content = self.lines[self.i]
        if _is_item(content):
            return self.sequence(indent)
        if self.split_key(content, number) is not None:
            return self.mapping(indent)
        value = self.inline(content, number)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][1] > parent:
            raise YAMLError("multi-line scalars are not supported", self.lines[self.i][0])
        return value

    def nested(self, parent: int, indentless: bool) -> Any:
        """The value on the lines after ``key:`` or ``-`` (null when none)."""
        if self.i >= len(self.lines):
            return None
        _, indent, content = self.lines[self.i]
        if indent > parent:
            return self.block(indent, parent)
        if indentless and indent == parent and _is_item(content):
            return self.sequence(indent)
        return None

    def sequence(self, indent: int) -> list:
        items = []
        while self.i < len(self.lines):
            number, ind, content = self.lines[self.i]
            if ind != indent or not _is_item(content):
                if ind > indent:
                    raise YAMLError("unexpected indentation", number)
                break
            rest = content[1:]
            stripped = rest.lstrip(_SPACE)
            if _blank_or_comment(rest):
                self.i += 1
                items.append(self.nested(indent, indentless=False))
            else:
                column = ind + 1 + len(rest) - len(stripped)
                self.lines[self.i] = (number, column, stripped)
                items.append(self.block(column, parent=indent))
        return items

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            number, ind, content = self.lines[self.i]
            if ind != indent:
                if ind > indent:
                    raise YAMLError("unexpected indentation", number)
                break
            if _is_item(content):
                raise YAMLError("a sequence item where a mapping key was expected", number)
            split = self.split_key(content, number)
            if split is None:
                raise YAMLError("expected 'key: value'", number)
            key, rest = split
            self.i += 1
            if _blank_or_comment(rest):
                out[key] = self.nested(indent, indentless=True)
            else:
                out[key] = self.inline(rest.lstrip(_SPACE), number)
                if self.i < len(self.lines) and self.lines[self.i][1] > indent:
                    raise YAMLError("multi-line scalars are not supported", self.lines[self.i][0])
        return out

    # -- one line --
    def split_key(self, content: str, number: int) -> Optional[Tuple[Any, str]]:
        """(key, the rest after ``:``) when ``content`` starts a mapping
        entry, else None."""
        if content[0] in "'\"":
            key, end = self.quoted(content, 0, number)
            after = content[end:].lstrip(_SPACE)
            if after.startswith(":") and (len(after) == 1 or after[1] in _SPACE):
                return key, after[1:]
            return None
        if content[0] in "[{" or content.startswith(("? ", "?\t")) or content == "?":
            if content[0] == "?":
                raise YAMLError("complex keys (?) are not supported", number)
            return None
        for pos, ch in enumerate(content):
            if ch == "#" and pos and content[pos - 1] in _SPACE:
                return None
            if ch == ":" and (pos + 1 == len(content) or content[pos + 1] in _SPACE):
                text = content[:pos].rstrip(_SPACE)
                if not text:
                    raise YAMLError("empty mapping keys are not supported", number)
                self.check_plain_start(text, number)
                return resolve_plain(text, number), content[pos + 1:]
        return None

    def check_plain_start(self, text: str, number: int) -> None:
        first = text[0]
        if first in "&*!|>%@`":
            raise YAMLError(f"anchors, aliases, tags and block scalars are not supported: "
                            f"{text!r}", number)
        if first in ",]}#" or (first in "-?:" and (len(text) == 1 or text[1] in _SPACE)):
            raise YAMLError(f"not a plain scalar: {text!r}", number)

    def inline(self, text: str, number: int) -> Any:
        """A value written on one line: quoted, a flow sequence, ``{}`` or a
        plain scalar (a comment may follow)."""
        if text[0] in "'\"":
            value, end = self.quoted(text, 0, number)
        elif text[0] == "[":
            value, end = self.flow(text, 0, number)
        elif text[0] == "{":
            m = re.match(r"\{[ \t]*\}", text)
            if not m:
                raise YAMLError("flow mappings are not supported", number)
            value, end = {}, m.end()
        else:
            for pos, ch in enumerate(text):
                if ch == "#" and pos and text[pos - 1] in _SPACE:
                    text = text[:pos].rstrip(_SPACE)
                    break
            self.check_plain_start(text, number)
            if re.search(r":(\s|$)", text):
                raise YAMLError(f"a mapping value inside a plain scalar: {text!r}", number)
            return resolve_plain(text, number)
        if not _blank_or_comment(text[end:]):
            raise YAMLError(f"unexpected text after a value: {text[end:]!r}", number)
        return value

    def quoted(self, text: str, pos: int, number: int) -> Tuple[str, int]:
        """The '…' or "…" scalar starting at ``pos`` → (value, end)."""
        quote, pos, out = text[pos], pos + 1, []
        while pos < len(text):
            ch = text[pos]
            if quote == "'" and ch == "'":
                if text.startswith("''", pos):
                    out.append("'")
                    pos += 2
                    continue
                return "".join(out), pos + 1
            if quote == '"' and ch == '"':
                return "".join(out), pos + 1
            if quote == '"' and ch == "\\":
                if pos + 1 >= len(text):
                    raise YAMLError("multi-line scalars are not supported", number)
                code = text[pos + 1]
                if code in _ESCAPES:
                    out.append(_ESCAPES[code])
                    pos += 2
                elif code in _HEX_ESCAPES:
                    width = _HEX_ESCAPES[code]
                    digits = text[pos + 2:pos + 2 + width]
                    if not re.fullmatch(r"[0-9a-fA-F]{%d}" % width, digits):
                        raise YAMLError(f"bad escape \\{code}{digits}", number)
                    out.append(chr(int(digits, 16)))
                    pos += 2 + width
                else:
                    raise YAMLError(f"unknown escape \\{code}", number)
                continue
            out.append(ch)
            pos += 1
        raise YAMLError("a quoted scalar must close on its line (multi-line scalars are "
                        "not supported)", number)

    def flow(self, text: str, pos: int, number: int) -> Tuple[list, int]:
        """The flow sequence starting at ``pos`` → (items, end)."""
        items, pos = [], pos + 1
        while True:
            while pos < len(text) and text[pos] in _SPACE:
                pos += 1
            if pos >= len(text):
                raise YAMLError("a flow sequence must close on its line", number)
            ch = text[pos]
            if ch == "]":
                return items, pos + 1
            if ch == "[":
                item, pos = self.flow(text, pos, number)
            elif ch in "'\"":
                item, pos = self.quoted(text, pos, number)
            elif ch == "{":
                m = re.compile(r"\{[ \t]*\}").match(text, pos)
                if not m:
                    raise YAMLError("flow mappings are not supported", number)
                item, pos = {}, m.end()
            else:
                end = pos
                while end < len(text) and text[end] not in ",[]{}":
                    if text[end] == "#" and text[end - 1] in _SPACE:
                        raise YAMLError("a flow sequence must close on its line", number)
                    if text[end] == ":" and (end + 1 == len(text) or text[end + 1] in " \t,[]{}"):
                        raise YAMLError("flow mappings are not supported", number)
                    end += 1
                plain = text[pos:end].rstrip(_SPACE)
                if not plain:
                    raise YAMLError("an empty entry in a flow sequence", number)
                self.check_plain_start(plain, number)
                if plain[0] in "?:" or (end < len(text) and text[end] in "[{"):
                    raise YAMLError(f"not a flow scalar: {text[pos:]!r}", number)
                item, pos = resolve_plain(plain, number), end
            items.append(item)
            while pos < len(text) and text[pos] in _SPACE:
                pos += 1
            if pos < len(text) and text[pos] == ",":
                pos += 1
            elif pos < len(text) and text[pos] == "]":
                return items, pos + 1
            else:
                raise YAMLError("expected ',' or ']' in a flow sequence", number)


def load(text: str) -> Any:
    """The value of a YAML document in the subset (None for an empty one)."""
    if text.startswith("\ufeff"):
        text = text[1:]
    return _Reader(text).document()


def read(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read())


# ---- writer ----------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"[A-Za-z_./][A-Za-z0-9_./ ()+-]*")
# what PyYAML reads inside single quotes as it stands: its printable set less
# the line breaks (NEL, LS, PS) and the byte-order mark
_SINGLE_SAFE = re.compile("[\x20-\x7e\xa0-\u2027\u202a-\ud7ff\ue000-\ufefe\uff00-\ufffd"
                          "\U00010000-\U0010ffff]*")
_WRITE_ESCAPES = {"\0": "0", "\a": "a", "\b": "b", "\t": "t", "\n": "n", "\v": "v", "\f": "f",
                  "\r": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N", "\xa0": "_",
                  "\u2028": "L", "\u2029": "P"}


def _plain_is_string(text: str) -> bool:
    try:
        return resolve_plain(text) == text and isinstance(resolve_plain(text), str)
    except YAMLError:
        return False


def _string(text: str) -> str:
    """Plain only where the reader gives the same string back; quoted
    wherever it would resolve to another type (``'1e-3'``, ``'null'``,
    ``'yes'``, ``''``) and for every string that starts with a digit or
    ``-``."""
    if (_PLAIN_SAFE.fullmatch(text) and not text.endswith(" ") and "  " not in text
            and _plain_is_string(text)):
        return text
    if _SINGLE_SAFE.fullmatch(text):
        return "'" + text.replace("'", "''") + "'"
    out = []
    for ch in text:
        if ch in _WRITE_ESCAPES:
            out.append("\\" + _WRITE_ESCAPES[ch])
        elif _SINGLE_SAFE.fullmatch(ch):
            out.append(ch)
        elif ord(ch) < 0x100:
            out.append(f"\\x{ord(ch):02X}")
        elif ord(ch) < 0x10000:
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(f"\\U{ord(ch):08X}")
    return '"' + "".join(out) + '"'


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(int(value))
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(float(value)).lower()
        if "." not in text and "e" in text:  # PyYAML's represent_float: 1e-05 → 1.0e-05
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        return _string(value)
    raise TypeError(f"yaml_lite cannot write {type(value).__name__}: {value!r}")


def _node(value: Any, indent: int) -> List[str]:
    """Block lines of ``value``, each starting at column ``indent``."""
    pad = " " * indent
    if isinstance(value, dict) and value:
        lines = []
        for key, item in value.items():
            if isinstance(key, (dict, list)):
                raise TypeError(f"yaml_lite writes scalar keys only: {key!r}")
            head = f"{pad}{_scalar(key)}:"
            if isinstance(item, dict) and item:
                lines += [head] + _node(item, indent + 2)
            elif isinstance(item, list) and item:
                lines += [head] + _node(item, indent)  # indentless, as safe_dump writes
            else:
                lines.append(f"{head} {_scalar_or_empty(item)}")
        return lines
    if isinstance(value, list) and value:
        lines = []
        for item in value:
            if isinstance(item, (dict, list)) and item:
                sub = _node(item, indent + 2)
                lines += [f"{pad}- {sub[0][indent + 2:]}"] + sub[1:]
            else:
                lines.append(f"{pad}- {_scalar_or_empty(item)}")
        return lines
    return [pad + _scalar_or_empty(value)]


def _scalar_or_empty(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar(value)


def dump(value: Any) -> str:
    """``value`` (dicts, lists, None, bool, int, float, str) as block YAML,
    keys in insertion order; ``load`` and ``yaml.safe_load`` read it back
    equal."""
    return "\n".join(_node(value, 0)) + "\n"


def write(value: Any, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dump(value))
