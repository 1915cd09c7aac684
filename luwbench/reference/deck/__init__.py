from .schema import (
    FIELD_MAP,
    FIELD_ORDER,
    FIELDS,
    MODE_BITS,
    SECTION_ORDER,
    SECTIONS,
    export_schema_json,
    normalize_key,
    parse_bool_token,
    sanitize_key,
    strip_quotes,
)
from .document import (
    DeckDocument,
    DeckParseError,
    deck_mode_from_path,
    load_deck,
    parse_deck_text,
)

__all__ = [
    "FIELD_MAP", "FIELD_ORDER", "FIELDS", "MODE_BITS", "SECTION_ORDER", "SECTIONS",
    "export_schema_json", "normalize_key", "parse_bool_token", "sanitize_key", "strip_quotes",
    "DeckDocument", "DeckParseError", "deck_mode_from_path",
    "load_deck", "parse_deck_text",
]
