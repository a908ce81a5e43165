"""Fetch-payload stream codecs: the compression/encryption wrap hooks.

The reference wraps every fetched stream through the engine's
serializerManager, which applies compression AND (when the engine enables
it) encryption (scala/RdmaShuffleReader.scala:118-128) — the plugin
itself ships no cipher, it delegates. Same contract here: the serving
side applies the configured codec to fetch payloads (after wire
compression), the reading side inverts it, and engines can register
their own codecs at runtime.

Codecs take an ``aad`` (associated data) argument binding the payload to
its request context (req_id, shuffle_id, flags): a recorded response
replayed or swapped onto a different request fails verification even
though the bytes themselves are authentic.

Built-ins:

* ``hmac-sha256`` — integrity (stdlib): appends a keyed MAC over
  aad+payload; tampering or a wrong key fails the fetch instead of
  feeding corrupt rows.
* ``aes-gcm`` — authenticated encryption via the ``cryptography``
  package (registered only when importable; random 96-bit nonce per
  payload, prepended; aad as GCM associated data).

Config: ``wire_codec`` names the codec; ``wire_codec_key`` is the hex
key. Key material is validated at resolve() time (16+ bytes; aes-gcm
requires exactly 16/24/32) so a bad key fails endpoint construction, not
the first fetch inside a server handler thread.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple


class CodecError(ValueError):
    """Payload failed to unwrap (bad key, tampering, or truncation)."""


def _default_key_ok(key: bytes) -> Optional[str]:
    return None if len(key) >= 16 else "key must be at least 16 bytes"


@dataclass(frozen=True)
class Codec:
    name: str
    wrap: Callable[[bytes, bytes, bytes], bytes]    # (payload, key, aad)
    unwrap: Callable[[bytes, bytes, bytes], bytes]  # (wire, key, aad)
    key_ok: Callable[[bytes], Optional[str]] = field(
        default=_default_key_ok)  # None when valid, else the problem


_REGISTRY: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> None:
    _REGISTRY[codec.name] = codec


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise CodecError(
            f"unknown wire codec {name!r} (registered: "
            f"{sorted(_REGISTRY)})") from None


def resolve(conf) -> Tuple[Optional[Codec], bytes]:
    """(codec, key bytes) per config, or (None, b"") when disabled.

    Raises CodecError on unknown codec or bad key — a security knob must
    fail loudly at startup, never silently fall back to plaintext.
    """
    name = conf.wire_codec
    if not name:
        return None, b""
    codec = get_codec(name)
    try:
        key = bytes.fromhex(conf.wire_codec_key)
    except ValueError:
        raise CodecError("wire_codec_key must be hex") from None
    problem = codec.key_ok(key)
    if problem is not None:
        raise CodecError(f"wire_codec_key invalid for {name}: {problem}")
    return codec, key


# -- built-ins ------------------------------------------------------------

_MAC = 32


def _hmac_wrap(payload: bytes, key: bytes, aad: bytes) -> bytes:
    mac = hmac_mod.new(key, aad + payload, hashlib.sha256).digest()
    return payload + mac


def _hmac_unwrap(data: bytes, key: bytes, aad: bytes) -> bytes:
    if len(data) < _MAC:
        raise CodecError("hmac payload truncated")
    payload, mac = data[:-_MAC], data[-_MAC:]
    want = hmac_mod.new(key, aad + payload, hashlib.sha256).digest()
    if not hmac_mod.compare_digest(mac, want):
        raise CodecError("hmac verification failed (tampering, bad key, "
                         "or replay onto a different request)")
    return payload


register_codec(Codec("hmac-sha256", _hmac_wrap, _hmac_unwrap))

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    def _gcm_key_ok(key: bytes) -> Optional[str]:
        return (None if len(key) in (16, 24, 32)
                else "aes-gcm needs a 16/24/32-byte key")

    def _gcm_wrap(payload: bytes, key: bytes, aad: bytes) -> bytes:
        nonce = os.urandom(12)
        return nonce + AESGCM(key).encrypt(nonce, payload, aad)

    def _gcm_unwrap(data: bytes, key: bytes, aad: bytes) -> bytes:
        if len(data) < 12 + 16:
            raise CodecError("aes-gcm payload truncated")
        try:
            return AESGCM(key).decrypt(data[:12], data[12:], aad)
        except Exception as e:  # InvalidTag and key-size errors
            raise CodecError(f"aes-gcm decrypt failed: {e}") from None

    register_codec(Codec("aes-gcm", _gcm_wrap, _gcm_unwrap, _gcm_key_ok))
except ImportError:  # cryptography not installed: engines register theirs
    pass
