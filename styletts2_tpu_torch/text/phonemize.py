"""G2P text -> IPA phonemes (ref: Demo notebooks cell 8; README.md:37-41), a
copy of the JAX package's ``text/phonemize.py``.

Phonemization is host-side CPU preprocessing in the reference too
(espeak-ng via the ``phonemizer`` package).  The dependency is optional: when
``phonemizer``/espeak-ng is unavailable this module raises a clear error, and
all engine APIs accept pre-phonemized strings.

The demo text pipeline is reproduced: strip, drop double quotes (LJSpeech
demo), phonemize with espeak en-us (preserve_punctuation, with_stress), NLTK
word-tokenize, re-join with spaces.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

_BACKEND = None


def _get_backend(language: str = "en-us"):
    global _BACKEND
    if _BACKEND is None:
        try:
            import phonemizer
        except ImportError as exc:  # pragma: no cover
            raise ImportError(
                "phonemizer (with espeak-ng) is not installed. Pass "
                "pre-phonemized strings to the engine, or install phonemizer."
            ) from exc
        _BACKEND = phonemizer.backend.EspeakBackend(
            language=language, preserve_punctuation=True, with_stress=True)
    return _BACKEND


def _word_tokenize(text: str) -> List[str]:
    try:
        from nltk.tokenize import word_tokenize

        return word_tokenize(text)
    except LookupError:          # missing punkt data — fall back to split
        return text.split()


def phonemize(text: str, language: str = "en-us",
              strip_quotes: bool = True) -> str:
    """Text -> space-joined IPA phoneme string (demo-notebook pipeline)."""
    text = text.strip()
    if strip_quotes:
        text = text.replace('"', "")
    backend = _get_backend(language)
    ps = backend.phonemize([text])
    return " ".join(_word_tokenize(ps[0]))


def phonemize_sentences(texts: Sequence[str], language: str = "en-us") -> List[str]:
    return [phonemize(t, language) for t in texts]
