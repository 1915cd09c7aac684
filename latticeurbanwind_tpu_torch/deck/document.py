"""Deck document: order-insensitive parse + canonicalizing render of `.luw*` decks.

Behavioral contract (parity with the reference deck layer, observed from
the reference's `core/deck_io.py` behavior and the example decks — this
implementation is an independent design):
  * `key = value` lines; `//` starts a comment (respecting quotes); a comment
    line whose text matches a section title/alias switches the current section.
  * keys are normalized (dashes/spaces -> underscores, aliases -> canonical).
  * unknown keys are preserved and rendered in the `custom` (or current) section.
  * duplicate keys keep the last value; earlier values stay queryable.
  * getters are tolerant: quotes stripped, fuzzy bools, NaN floats rejected.
  * `render()` rebuilds the deck in canonical section order, rewrites fuzzy
    bools to true/false and re-brackets list values.
The deck is a mutable case database: pipeline stages write derived values back.

Internal design: the parser is a small lexer that classifies each physical
line into a tagged record (section switch / key-value / free text / blank);
the document then stores values in flat parallel maps keyed by canonical key
(no per-entry objects) plus per-section sequences for unknown keys and
free-text lines.  Rendering is a single pass over the schema's section order
that re-canonicalizes each value through one formatting function.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from .schema import (
    FIELD_MAP,
    FIELD_ORDER,
    FIELD_SECTION,
    LIST_KINDS,
    SECTION_ALIASES,
    SECTION_ORDER,
    SECTION_TITLES,
    normalize_key,
    parse_bool_token,
    strip_quotes,
)

_CUSTOM = "custom"
_DEFAULT_HEADER = "// LUW deck"   # format magic for decks created from scratch


class DeckParseError(ValueError):
    """Fatal deck syntax problem (strict mode)."""


# ---------------------------------------------------------------------------
# Lexer: physical lines -> tagged records
# ---------------------------------------------------------------------------

# record tags
_SECTION, _PAIR, _TEXT, _BLANK = "section", "pair", "text", "blank"


def _canon_title(text: str) -> str:
    """Lower-cased, whitespace-collapsed section label; tolerates [brackets]."""
    t = text.strip().lower()
    if t[:1] == "[":
        close = t.find("]")
        if close >= 0:
            t = t[1:close]
    return " ".join(t.split())


def _build_section_table() -> Dict[str, str]:
    table: Dict[str, str] = {}
    for sid in SECTION_ORDER:
        names = [sid, SECTION_TITLES[sid], *SECTION_ALIASES[sid]]
        for name in names:
            table[_canon_title(name)] = sid
    return table


_SECTION_TABLE = _build_section_table()


def _comment_split(line: str) -> Tuple[str, str]:
    """Split a line at the first `//` that sits outside quotes.

    Returns (content, comment) where comment includes the slashes ('' if none).
    """
    quote = ""          # active quote char, or empty
    i, n = 0, len(line)
    while i < n - 1:
        ch = line[i]
        if quote:
            if ch == quote:
                quote = ""
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "/" and line[i + 1] == "/":
            return line[:i], line[i:].strip()
        i += 1
    return line, ""


def _lex(text: str) -> Iterator[tuple]:
    """Yield (tag, *payload) records, one per physical line.

    _SECTION: (tag, section_id)
    _PAIR:    (tag, canonical_key, raw_value, trailing_comment)
    _TEXT:    (tag, original_line)
    _BLANK:   (tag,)
    """
    for raw in text.splitlines():
        line = raw.rstrip()
        body = line.strip()
        if not body:
            yield (_BLANK,)
            continue
        # section switch?  a pure comment line whose label is a known title
        for marker in ("//", "#"):
            if body.startswith(marker):
                sid = _SECTION_TABLE.get(_canon_title(body[len(marker):]))
                if sid is not None:
                    yield (_SECTION, sid)
                else:
                    yield (_TEXT, line)
                break
        else:
            content, note = _comment_split(line)
            eq = content.find("=")
            key = normalize_key(content[:eq]) if eq > 0 else ""
            if key:
                yield (_PAIR, key, content[eq + 1:].strip(), note)
            else:
                yield (_TEXT, line)


def _split_items(raw: str) -> List[str]:
    """Bracketed-or-bare comma list -> stripped item strings."""
    body = raw.strip()
    if body[:1] == "[" and body[-1:] == "]":
        body = body[1:-1]
    return [item.strip() for item in body.split(",") if item.strip()]


def _format_scalar(value: object) -> str:
    if value is True:
        return "true"
    if value is False:
        return "false"
    if isinstance(value, float):
        return f"{value:.6f}"
    if isinstance(value, int):
        return str(value)
    return str(value).strip()


def _canonical_value(key: str, raw: str) -> str:
    """Rewrite a raw value into canonical deck form for rendering."""
    value = raw.strip()
    spec = FIELD_MAP.get(key)
    if spec is None or not value:
        return value
    if spec.kind == "boolean":
        flag = parse_bool_token(value)
        if flag is not None:
            return "true" if flag else "false"
    elif spec.kind in LIST_KINDS:
        return "[" + ", ".join(_split_items(value)) + "]"
    elif spec.quoted:
        return f'"{strip_quotes(value)}"'
    return value


# ---------------------------------------------------------------------------
# Document
# ---------------------------------------------------------------------------


class DeckDocument:
    """Parsed deck held as flat key->value maps plus layout metadata."""

    def __init__(self, path: Optional[Path] = None):
        self.path = path
        self._vals: Dict[str, str] = {}          # canonical key -> raw value
        self._notes: Dict[str, str] = {}         # trailing // comments
        self._homes: Dict[str, str] = {}         # section id per key
        self._extras: Dict[str, List[str]] = {}  # section -> unknown-key order
        self._prose: Dict[str, List[str]] = {}   # section -> free-text lines
        self._head: List[str] = []               # lines before any content
        self._earlier: Dict[str, List[str]] = {} # shadowed duplicate values

    # -- construction ------------------------------------------------------

    @classmethod
    def from_text(cls, text: str, *, path: Optional[Path] = None,
                  strict_duplicates: bool = False) -> "DeckDocument":
        doc = cls(path=path)
        at: Optional[str] = None     # current section, None until first switch
        virgin = True                # still inside the leading preamble

        for rec in _lex(text.replace("\r\n", "\n").replace("\r", "\n")):
            tag = rec[0]
            if tag == _SECTION:
                at = rec[1]
                virgin = False
            elif tag == _PAIR:
                _, key, value, note = rec
                doc._absorb(key, value, note, at)
                virgin = False
            elif tag == _TEXT:
                if virgin and at is None:
                    doc._head.append(rec[1])
                else:
                    doc._prose.setdefault(at or _CUSTOM, []).append(rec[1])
            else:  # blank
                if virgin and at is None:
                    doc._head.append("")

        if strict_duplicates and doc._earlier:
            names = ", ".join(sorted(doc._earlier))
            raise DeckParseError(f"deck defines the same key more than once: {names}")
        return doc

    @classmethod
    def load(cls, path: Path | str, *, strict_duplicates: bool = False) -> "DeckDocument":
        p = Path(path).expanduser().resolve()
        return cls.from_text(p.read_text(encoding="utf-8", errors="ignore"),
                             path=p, strict_duplicates=strict_duplicates)

    def _absorb(self, key: str, value: str, note: str, at: Optional[str]) -> None:
        """Record one parsed key=value occurrence."""
        if key in self._vals:
            self._earlier.setdefault(key, []).append(self._vals[key])
        home = FIELD_SECTION.get(key)
        if home is None:
            home = at or _CUSTOM
            seq = self._extras.setdefault(home, [])
            if key not in seq:
                seq.append(key)
        self._vals[key] = value
        self._homes[key] = home
        if note:
            self._notes[key] = note

    # -- getters -----------------------------------------------------------

    def has(self, key: str) -> bool:
        return normalize_key(key) in self._vals

    def get_raw(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._vals.get(normalize_key(key), default)

    def get_text(self, key: str, default: Optional[str] = None) -> Optional[str]:
        raw = self._vals.get(normalize_key(key))
        return default if raw is None else strip_quotes(raw)

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        text = self.get_text(key)
        if not text:
            return default
        try:
            return int(text)
        except ValueError:
            return default

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        text = self.get_text(key)
        if not text:
            return default
        try:
            value = float(text)
        except ValueError:
            return default
        return default if math.isnan(value) else value

    def get_bool(self, key: str, default: Optional[bool] = None) -> Optional[bool]:
        text = self.get_text(key)
        if text is None:
            return default
        flag = parse_bool_token(text)
        return default if flag is None else flag

    def get_list(self, key: str) -> List[str]:
        raw = self.get_raw(key)
        return _split_items(raw) if raw is not None else []

    def get_float_list(self, key: str) -> List[float]:
        try:
            return [float(item) for item in self.get_list(key)]
        except ValueError:
            return []

    def get_int_list(self, key: str) -> List[int]:
        try:
            return [int(float(item)) for item in self.get_list(key)]
        except ValueError:
            return []

    def get_pair(self, key: str) -> Optional[Tuple[float, float]]:
        values = self.get_float_list(key)
        if len(values) != 2:
            return None
        return min(values), max(values)

    # -- setters -----------------------------------------------------------

    def set_raw(self, key: str, value: str, *, section: Optional[str] = None,
                comment: Optional[str] = None) -> None:
        k = normalize_key(key)
        home = section or FIELD_SECTION.get(k) or self._homes.get(k) or _CUSTOM
        if k not in FIELD_SECTION:
            seq = self._extras.setdefault(home, [])
            if k not in seq:
                seq.append(k)
        self._vals[k] = value.strip()
        self._homes[k] = home
        self._earlier.pop(k, None)
        if comment is not None:
            self._notes[k] = comment.strip()

    def set_text(self, key: str, value: str, *, quoted: bool = False,
                 section: Optional[str] = None, comment: Optional[str] = None) -> None:
        body = value.strip()
        self.set_raw(key, f'"{body}"' if quoted else body,
                     section=section, comment=comment)

    def set_int(self, key: str, value: int, **kw) -> None:
        self.set_raw(key, str(int(value)), **kw)

    def set_float(self, key: str, value: float, *, precision: int = 6, **kw) -> None:
        self.set_raw(key, f"{float(value):.{precision}f}", **kw)

    def set_bool(self, key: str, value: bool, **kw) -> None:
        self.set_raw(key, "true" if value else "false", **kw)

    def set_list(self, key: str, values: Iterable[object], **kw) -> None:
        self.set_raw(key, "[" + ", ".join(map(_format_scalar, values)) + "]", **kw)

    def set_pair(self, key: str, pair: Iterable[float], *, precision: int = 6, **kw) -> None:
        a_b = [f"{float(v):.{precision}f}" for v in pair]
        if len(a_b) != 2:
            raise ValueError(f"{key} expects exactly 2 values, got {len(a_b)}")
        self.set_raw(key, f"[{a_b[0]}, {a_b[1]}]", **kw)

    def remove(self, key: str) -> None:
        k = normalize_key(key)
        self._vals.pop(k, None)
        self._notes.pop(k, None)
        self._earlier.pop(k, None)
        home = self._homes.pop(k, None)
        if home in self._extras and k in self._extras[home]:
            self._extras[home].remove(k)

    def duplicate_keys(self) -> List[str]:
        return sorted(self._earlier)

    def to_dict(self) -> Dict[str, str]:
        return dict(self._vals)

    # -- rendering ---------------------------------------------------------

    def _emit_line(self, key: str) -> str:
        parts = [f"{key} ="]
        value = _canonical_value(key, self._vals[key])
        if value:
            parts.append(value)
        note = self._notes.get(key)
        if note:
            parts.append(note)
        return " ".join(parts)

    def _section_keys(self, sid: str) -> List[str]:
        ordered = [k for k in FIELD_ORDER.get(sid, ()) if self._homes.get(k) == sid]
        ordered += [k for k in self._extras.get(sid, ()) if self._homes.get(k) == sid]
        return [k for k in ordered if k in self._vals]

    def render(self) -> str:
        head = list(self._head)
        while head and not head[-1].strip():
            head.pop()
        out: List[str] = head if head else [_DEFAULT_HEADER]
        for sid in SECTION_ORDER:
            keys = self._section_keys(sid)
            prose = [ln for ln in self._prose.get(sid, ()) if ln.strip()]
            if not keys and not prose:
                continue
            out.append("")
            out.append(f"// {SECTION_TITLES.get(sid, sid.title())}")
            out.extend(prose)
            out.extend(self._emit_line(k) for k in keys)
        return "\n".join(out) + "\n"

    def save(self, path: Optional[Path | str] = None) -> Path:
        target = Path(path).expanduser().resolve() if path is not None else self.path
        if target is None:
            raise ValueError("No target path provided for deck save.")
        target.write_text(self.render(), encoding="utf-8")
        self.path = target
        return target


def load_deck(path: Path | str, *, strict_duplicates: bool = False) -> DeckDocument:
    return DeckDocument.load(path, strict_duplicates=strict_duplicates)


def parse_deck_text(text: str, *, strict_duplicates: bool = False) -> DeckDocument:
    return DeckDocument.from_text(text, strict_duplicates=strict_duplicates)


def deck_mode_from_path(path: Path | str) -> str:
    """Run mode from deck extension: .luw standard, .luwdg dataset-gen, .luwpf profile."""
    suffix = Path(path).suffix.lower().lstrip(".")
    if suffix in ("luw", "luwdg", "luwpf"):
        return suffix
    raise ValueError(f"Unrecognized deck extension: {path}")
