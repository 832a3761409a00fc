"""Deck loader: the YAML subset that ``examples/decks/*.yaml`` use.

Supported: block maps nested by indentation, block lists whose items
are scalars or flow collections, flow lists and flow maps (which may
span lines), single- or double-quoted keys and scalars, and ``#``
comments.  Plain scalars resolve as YAML 1.2's core schema does: ints,
floats, ``true``/``false``, ``null``/``~``; anything else is a string.

Anything outside that subset raises ``DeckError`` instead of guessing:
anchors, aliases, tags, block scalars, multi-document streams, tabs in
indentation, duplicate keys, block maps inside list items, and the
YAML 1.1 booleans (``yes``/``no``/``on``/``off``), which mean a string
to some parsers and a boolean to others — quote them.
"""
from __future__ import annotations

import re

__all__ = ["DeckError", "load_deck", "parse_deck"]


class DeckError(ValueError):
    """The text is not in the supported deck subset."""


_INT = re.compile(r"[-+]?[0-9]+\Z")
_FLOAT = re.compile(
    r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?\Z")
_SPECIAL = {"true": True, "True": True, "TRUE": True,
            "false": False, "False": False, "FALSE": False,
            "null": None, "Null": None, "NULL": None, "~": None,
            ".inf": float("inf"), "+.inf": float("inf"),
            "-.inf": float("-inf"), ".nan": float("nan")}
_AMBIGUOUS = {"yes", "no", "on", "off", "y", "n"}
_RESERVED_START = set("&*!|>%@`")


def _scalar(tok: str, where: str):
    if tok in _SPECIAL:
        return _SPECIAL[tok]
    if tok.lower() in _AMBIGUOUS:
        raise DeckError(f"{where}: ambiguous scalar {tok!r}; quote it")
    if tok[0] in _RESERVED_START or tok.startswith("- ") or tok == "-":
        raise DeckError(f"{where}: unsupported YAML syntax {tok!r}")
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(text: str, i: int, where: str):
    """Parse a quoted scalar starting at text[i]; return (value, end)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        ch = text[j]
        if q == "'" and ch == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            esc = text[j + 1:j + 2]
            if esc not in ('"', "\\"):
                raise DeckError(f"{where}: unsupported escape \\{esc}")
            out.append(esc)
            j += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise DeckError(f"{where}: unterminated quote")


class _Flow:
    """Recursive-descent parser for one flow collection or scalar."""

    def __init__(self, text: str, where: str):
        self.t = text
        self.i = 0
        self.where = where

    def ws(self):
        while self.i < len(self.t) and self.t[self.i] in " \t\n":
            self.i += 1

    def peek(self):
        self.ws()
        return self.t[self.i] if self.i < len(self.t) else ""

    def expect(self, ch):
        if self.peek() != ch:
            raise DeckError(f"{self.where}: expected {ch!r} in {self.t!r}")
        self.i += 1

    def value(self):
        c = self.peek()
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        return self.scalar(in_key=False)

    def scalar(self, in_key: bool):
        c = self.peek()
        if c in "\"'":
            v, self.i = _quoted(self.t, self.i, self.where)
            return v
        start = self.i
        while self.i < len(self.t):
            ch = self.t[self.i]
            if ch in ",[]{}":
                break
            if ch == ":" and (self.i + 1 == len(self.t)
                              or self.t[self.i + 1] in " \t\n,[]{}"):
                break
            self.i += 1
        tok = self.t[start:self.i].strip()
        if not tok:
            raise DeckError(f"{self.where}: empty value in {self.t!r}")
        if "\n" in tok:
            raise DeckError(f"{self.where}: multi-line plain scalar")
        return tok if in_key else _scalar(tok, self.where)

    def seq(self):
        self.expect("[")
        out = []
        if self.peek() == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value())
            c = self.peek()
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                raise DeckError(f"{self.where}: expected ',' or ']' in "
                                f"{self.t!r}")

    def map(self):
        self.expect("{")
        out = {}
        if self.peek() == "}":
            self.i += 1
            return out
        while True:
            k = self.scalar(in_key=True)
            self.expect(":")
            if k in out:
                raise DeckError(f"{self.where}: duplicate key {k!r}")
            out[k] = self.value()
            c = self.peek()
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                raise DeckError(f"{self.where}: expected ',' or '}}' in "
                                f"{self.t!r}")

    def parse(self):
        v = self.value()
        if self.peek():
            raise DeckError(f"{self.where}: trailing text in {self.t!r}")
        return v


def _flow_value(text: str, where: str):
    return _Flow(text, where).parse()


def _logical_lines(text: str):
    """(indent, content, lineno) with comments and blank lines dropped and
    multi-line flow collections joined."""
    raw = text.splitlines()
    out = []
    i = 0
    while i < len(raw):
        line = raw[i]
        lineno = i + 1
        i += 1
        body = _strip_comment(line)
        if not body.strip():
            continue
        lead = body[:len(body) - len(body.lstrip())]
        if "\t" in lead:
            raise DeckError(f"line {lineno}: tab in indentation")
        content = body.strip()
        if content in ("---", "...") or content.startswith("%"):
            raise DeckError(f"line {lineno}: directives and document "
                            "markers are not supported")
        # join continuation lines until brackets balance
        while _depth(content) > 0:
            if i >= len(raw):
                raise DeckError(f"line {lineno}: unclosed flow collection")
            content += "\n" + _strip_comment(raw[i]).strip()
            i += 1
        if _depth(content) < 0:
            raise DeckError(f"line {lineno}: unbalanced brackets")
        out.append((len(lead), content, lineno))
    return out


def _depth(s: str) -> int:
    d = 0
    quote = None
    for ch in s:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            d += 1
        elif ch in "]}":
            d -= 1
    return d


def _split_key(content: str, where: str):
    """'key: rest' -> (key, rest); the key may be quoted."""
    if content[0] in "\"'":
        key, j = _quoted(content, 0, where)
    else:
        m = re.match(r"([^:#\[\]{},\"']+?)\s*(?=:(\s|$))", content)
        if not m:
            raise DeckError(f"{where}: expected 'key: value', got "
                            f"{content!r}")
        key, j = m.group(1), m.end()
        if key[0] in _RESERVED_START or key.startswith("? "):
            raise DeckError(f"{where}: unsupported key syntax {key!r}")
    rest = content[j:]
    if not rest.startswith(":"):
        raise DeckError(f"{where}: expected ':' after key {key!r}")
    return key, rest[1:].strip()


class _Block:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def node(self, indent: int):
        ind, content, _ = self.lines[self.i]
        if content == "-" or content.startswith("- "):
            return self.seq(ind)
        return self.map(ind)

    def seq(self, indent: int):
        out = []
        while self.i < len(self.lines):
            ind, content, lineno = self.lines[self.i]
            if ind < indent:
                break
            where = f"line {lineno}"
            if ind > indent:
                raise DeckError(f"{where}: unexpected indentation")
            if not (content == "-" or content.startswith("- ")):
                break
            item = content[1:].strip()
            if not item:
                raise DeckError(f"{where}: nested block under a list item "
                                "is not supported; use a flow collection")
            if item[0] not in "[{\"'" and re.search(r":(\s|$)", item):
                raise DeckError(f"{where}: block map inside a list item is "
                                "not supported; use {key: value}")
            out.append(_flow_value(item, where))
            self.i += 1
        return out

    def map(self, indent: int):
        out = {}
        while self.i < len(self.lines):
            ind, content, lineno = self.lines[self.i]
            if ind < indent:
                break
            where = f"line {lineno}"
            if ind > indent:
                raise DeckError(f"{where}: unexpected indentation")
            if content == "-" or content.startswith("- "):
                break
            key, rest = _split_key(content, where)
            if key in out:
                raise DeckError(f"{where}: duplicate key {key!r}")
            self.i += 1
            if rest:
                out[key] = _flow_value(rest, where)
                continue
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if nxt is not None and (
                    nxt[0] > indent
                    or (nxt[0] == indent and (nxt[1] == "-"
                                              or nxt[1].startswith("- ")))):
                out[key] = self.node(nxt[0])
            else:
                out[key] = None
        return out


def parse_deck(text: str) -> dict:
    """Parse deck text; the top level must be a map."""
    lines = _logical_lines(text)
    if not lines:
        return {}
    if lines[0][0] != 0:
        raise DeckError(f"line {lines[0][2]}: top level must not be "
                        "indented")
    b = _Block(lines)
    out = b.node(0)
    if b.i != len(lines):
        raise DeckError(f"line {lines[b.i][2]}: unexpected content")
    if not isinstance(out, dict):
        raise DeckError("a deck's top level must be a map")
    return out


def load_deck(path: str) -> dict:
    """Read and parse one deck file."""
    with open(path) as f:
        text = f.read()
    try:
        return parse_deck(text)
    except DeckError as e:
        raise DeckError(f"{path}: {e}") from None
