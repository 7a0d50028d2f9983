"""Auth — the cephx seam: pre-shared keyring + derived session tickets.

The port's copy of ``ceph_tpu/msg/auth.py``.

The role of src/auth (CephX): daemons and clients hold a keyring
distributed out of band (the /etc/ceph keyring model); the monitor
issues time-limited session tickets whose keys are DERIVED from the
cluster key (HMAC(cluster_key, name || expiry)), so any keyring holder
verifies a ticket statelessly; messages are authenticated with an HMAC
over the frame (the ProtocolV2 "secure"-mode integrity property).

Wire shape: an authenticated frame carries ``mac`` =
HMAC-SHA256(key, canonical-json(frame minus mac)).  The messenger
signs every outgoing frame and drops inbound frames whose mac is
missing or wrong when a keyring is configured.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import time
from typing import Dict, Optional

from ..common import encoding

# wire-form versions for the persisted/transported auth structures
# (wirecheck registry entries msg.auth.keyring / msg.auth.ticket)
KEYRING_V = 1
TICKET_V = 1


def encode_ticket(ticket: Dict) -> str:
    """Session tickets travel and persist through the versioned
    envelope: a future ticket format (caps, audiences) must be
    refusable by old readers, not silently misverified."""
    return encoding.encode(dict(ticket), TICKET_V, 1)


def decode_ticket(blob) -> Dict:
    """Lenient: pre-envelope raw-dict tickets (writer v0) still
    decode."""
    v, data = encoding.decode_any(blob, supported=TICKET_V,
                                  struct="msg.auth.ticket")
    if not isinstance(data, dict):
        raise encoding.MalformedInput(
            f"msg.auth.ticket v{v}: payload is not an object")
    return data


class Keyring:
    def __init__(self, key: bytes):
        self.key = key

    @classmethod
    def generate(cls) -> "Keyring":
        return cls(os.urandom(32))

    @classmethod
    def from_hex(cls, s: str) -> "Keyring":
        return cls(bytes.fromhex(s))

    def to_hex(self) -> str:
        return self.key.hex()

    # -- versioned keyring file form (the /etc/ceph keyring role) -----
    def to_wire(self) -> str:
        return encoding.encode({"key": self.key.hex()}, KEYRING_V, 1)

    @classmethod
    def from_wire(cls, blob) -> "Keyring":
        v, data = encoding.decode(blob, supported=KEYRING_V,
                                  struct="msg.auth.keyring")
        try:
            return cls(bytes.fromhex(data["key"]))
        except (KeyError, TypeError, ValueError) as e:
            raise encoding.MalformedInput(
                f"msg.auth.keyring v{v}: bad payload: {e!r}")

    # -- frame authentication -----------------------------------------
    @staticmethod
    def _canonical(msg: Dict, blobs=None) -> bytes:
        body = {k: v for k, v in msg.items() if k != "mac"}
        out = json.dumps(body, sort_keys=True,  # wire-ok: MAC canonical form, never decoded
                         separators=(",", ":")).encode()
        # data segments are covered by their digests, so a tampered
        # raw attachment breaks the frame MAC exactly like a tampered
        # control field
        for b in (blobs or ()):
            out += hashlib.sha256(b).digest()
        return out

    def sign(self, msg: Dict, blobs=None) -> str:
        return hmac.new(self.key, self._canonical(msg, blobs),
                        hashlib.sha256).hexdigest()

    def verify(self, msg: Dict, blobs=None) -> bool:
        mac = msg.get("mac")
        if not isinstance(mac, str):
            return False
        return hmac.compare_digest(mac, self.sign(msg, blobs))

    # -- session tickets (CephX ticket flow) --------------------------
    def issue_ticket(self, name: str, lifetime: float = 3600.0,
                     now: Optional[float] = None) -> Dict:
        """``now`` pins the clock (corpus generation, tests);
        defaults to wall time."""
        expires = (time.time() if now is None else now) + lifetime
        seed = f"{name}:{expires:.3f}".encode()
        session = hmac.new(self.key, seed, hashlib.sha256).hexdigest()
        return {"name": name, "expires": round(expires, 3),
                "session_key": session}

    def verify_ticket(self, ticket: Dict) -> bool:
        try:
            if float(ticket["expires"]) < time.time():
                return False
            seed = (f"{ticket['name']}:"
                    f"{float(ticket['expires']):.3f}").encode()
            want = hmac.new(self.key, seed,
                            hashlib.sha256).hexdigest()
            return hmac.compare_digest(want, ticket["session_key"])
        except (KeyError, TypeError, ValueError):
            return False
