"""Minimal protobuf text-format parser.

Parses the ``.config`` text-proto files used by the SECOND family of
configs (reference: second/protos/*.proto, parsed upstream with
``google.protobuf.text_format.Merge`` at second/pytorch/train.py:163-166)
into a plain raw tree, without requiring protoc-generated classes.

The raw tree representation is::

    RawMessage = dict[str, list[value]]

where each value is a ``str`` (unparsed scalar token, interpretation is
deferred to the schema layer), or a nested ``RawMessage``.  Every field
collects into a list so repeated fields need no special casing; the
schema layer picks ``[-1]`` for singular fields (proto3 last-one-wins
semantics for scalars).

Supported syntax (the subset the reference configs exercise, plus a bit):
  - ``name: value`` and ``name { ... }`` / ``name: { ... }``
  - scalar lists ``name: [v1, v2, ...]``
  - strings with escapes, numbers (int/float/exponent), bools
    (true/false/True/False), bare enum identifiers
  - ``#`` and ``//`` comments
"""

from __future__ import annotations

from typing import Dict, List, Union

RawValue = Union[str, "RawMessage"]
RawMessage = Dict[str, List[RawValue]]


class TextProtoError(ValueError):
    pass


_PUNCT = set("{}[]:,;")
_WS = set(" \t\r\n")


def _tokenize(text: str) -> List[str]:
    toks: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in _WS:
            i += 1
        elif c == "#" or text.startswith("//", i):
            while i < n and text[i] != "\n":
                i += 1
        elif c in _PUNCT:
            toks.append(c)
            i += 1
        elif c in "\"'":
            quote = c
            j = i + 1
            buf = []
            while j < n and text[j] != quote:
                if text[j] == "\\" and j + 1 < n:
                    esc = text[j + 1]
                    buf.append({"n": "\n", "t": "\t", "\\": "\\", quote: quote}.get(esc, "\\" + esc))
                    j += 2
                else:
                    buf.append(text[j])
                    j += 1
            if j >= n:
                raise TextProtoError("unterminated string literal")
            # token is tagged with a leading quote so the parser can
            # distinguish string scalars from identifiers
            toks.append('"' + "".join(buf))
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in _WS and text[j] not in _PUNCT and text[j] != "#":
                j += 1
            toks.append(text[i:j])
            i = j
    return toks


class _Parser:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.pos = 0

    def peek(self) -> str:
        if self.pos >= len(self.toks):
            raise TextProtoError("unexpected end of input")
        return self.toks[self.pos]

    def next(self) -> str:
        tok = self.peek()
        self.pos += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise TextProtoError(f"expected {tok!r}, got {got!r}")

    def at_end(self) -> bool:
        return self.pos >= len(self.toks)

    def parse_message(self, *, top: bool) -> RawMessage:
        msg: RawMessage = {}
        while True:
            if self.at_end():
                if top:
                    return msg
                raise TextProtoError("unexpected end of input inside message")
            if not top and self.peek() == "}":
                self.next()
                return msg
            self._parse_field(msg)

    def _parse_field(self, msg: RawMessage) -> None:
        name = self.next()
        if name in _PUNCT or name.startswith('"'):
            raise TextProtoError(f"expected field name, got {name!r}")
        values = msg.setdefault(name, [])
        tok = self.peek()
        if tok == ":":
            self.next()
            tok = self.peek()
            if tok == "{":
                self.next()
                values.append(self.parse_message(top=False))
            elif tok == "[":
                self.next()
                self._parse_scalar_list(values)
            else:
                values.append(self._parse_scalar())
        elif tok == "{":
            self.next()
            values.append(self.parse_message(top=False))
        else:
            raise TextProtoError(f"field {name!r}: expected ':' or '{{', got {tok!r}")
        if not self.at_end() and self.peek() in (",", ";"):
            self.next()

    def _parse_scalar_list(self, values: List[RawValue]) -> None:
        if self.peek() == "]":  # empty list
            self.next()
            return
        while True:
            values.append(self._parse_scalar())
            tok = self.next()
            if tok == "]":
                return
            if tok != ",":
                raise TextProtoError(f"expected ',' or ']' in list, got {tok!r}")

    def _parse_scalar(self) -> str:
        tok = self.next()
        if tok in _PUNCT:
            raise TextProtoError(f"expected scalar, got {tok!r}")
        return tok


def parse(text: str) -> RawMessage:
    """Parse text-format proto into a raw ``{field: [values...]}`` tree."""
    return _Parser(_tokenize(text)).parse_message(top=True)


def parse_file(path) -> RawMessage:
    with open(path, "r") as f:
        return parse(f.read())
