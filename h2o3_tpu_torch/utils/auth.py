"""Pluggable REST authentication — the h2o-security login-module surface
(water/H2OSecurityManager.java + h2o-security/'s JAAS LoginModules:
-basic_auth, -ldap_login, -kerberos_login, -pam_login, -spnego_login).

Methods:
  * basic  — user:password file / dict, constant-time compare (default).
  * ldap   — REAL simple-bind against an LDAP server, implemented on the
             stdlib socket with minimal BER encoding (no ldap3 in this
             image): each login binds as `bind_template.format(user=…)`
             with the presented password; resultCode 0 = authenticated.
  * custom — a Python module exposing authenticate(user, password) (the
             generic LoginModule SPI).
  * kerberos / spnego / pam — loud-reject with guidance: these need a
             KDC/system-PAM stack that is not available here.

Selection via config (utils/config): ai.h2o.api.auth_method plus
ai.h2o.api.ldap_host / ldap_port / ldap_bind_template / ldap_use_ssl or
ai.h2o.api.auth_module. Successful logins are cached per (user, password
hash) for ldap/custom so each REST call doesn't re-bind.
"""

from __future__ import annotations

import hashlib
import hmac
import socket
import ssl as _ssl
from typing import Optional


# ---------------------------------------------------------------------------
# minimal BER/DER for the LDAPv3 simple bind (RFC 4511 §4.2)
def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _tlv(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + _ber_len(len(payload)) + payload


def _ber_int(v: int) -> bytes:
    body = v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big")
    return _tlv(0x02, body)


def bind_request(msg_id: int, dn: str, password: str) -> bytes:
    """LDAPMessage { messageID, [APPLICATION 0] BindRequest {version=3,
    name, simple[0] password} }"""
    bind = (_ber_int(3)
            + _tlv(0x04, dn.encode())
            + _tlv(0x80, password.encode()))       # [0] simple
    return _tlv(0x30, _ber_int(msg_id) + _tlv(0x60, bind))


def _read_tlv(buf: bytes, off: int):
    tag = buf[off]
    ln = buf[off + 1]
    off += 2
    if ln & 0x80:
        n = ln & 0x7F
        ln = int.from_bytes(buf[off:off + n], "big")
        off += n
    return tag, buf[off:off + ln], off + ln


def parse_bind_response(data: bytes) -> int:
    """→ resultCode (0 = success; RFC 4511 §4.2.2)."""
    _tag, msg, _ = _read_tlv(data, 0)              # LDAPMessage SEQUENCE
    _t, _mid, off = _read_tlv(msg, 0)              # messageID
    tag, resp, _ = _read_tlv(msg, off)             # [APPLICATION 1]
    if tag != 0x61:
        raise ValueError(f"not a BindResponse (tag 0x{tag:x})")
    _t, code, _ = _read_tlv(resp, 0)               # resultCode ENUMERATED
    return int.from_bytes(code, "big")


# ---------------------------------------------------------------------------
class BasicAuthenticator:
    """user:password dict with constant-time compares (-basic_auth)."""

    def __init__(self, creds: dict):
        self.creds = dict(creds)

    def authenticate(self, user: str, password: str) -> bool:
        ub, pb = user.encode(), password.encode()
        ok = False
        for u, p in self.creds.items():
            if hmac.compare_digest(ub, u.encode()) and \
                    hmac.compare_digest(pb, p.encode()):
                ok = True
        return ok


def _recv_tlv(sock) -> bytes:
    """Read one complete outer TLV (the LDAPMessage) — responses may
    arrive fragmented across TCP segments."""
    head = b""
    while len(head) < 2:
        part = sock.recv(2 - len(head))
        if not part:
            return head
        head += part
    ln = head[1]
    if ln & 0x80:
        n = ln & 0x7F
        while len(head) < 2 + n:
            part = sock.recv(2 + n - len(head))
            if not part:
                return head
            head += part
        total = 2 + n + int.from_bytes(head[2:2 + n], "big")
    else:
        total = 2 + ln
    buf = head
    while len(buf) < total:
        part = sock.recv(total - len(buf))
        if not part:
            break
        buf += part
    return buf


class LdapAuthenticator:
    """Per-login LDAP simple bind (-ldap_login). A successful bind as the
    templated DN with the presented password authenticates the user.
    Only SUCCESSES are cached (bounded, with a TTL) — failures always
    retry the directory, so transient outages cannot lock a user out and
    a revoked account ages out within `cache_ttl` seconds."""

    CACHE_MAX = 1024

    def __init__(self, host: str, port: int = 389,
                 bind_template: str = "uid={user}",
                 use_ssl: bool = False, timeout: float = 5.0,
                 cache_ttl: float = 300.0):
        import threading
        self.host = host
        self.port = int(port)
        self.bind_template = bind_template
        self.use_ssl = use_ssl
        self.timeout = timeout
        self.cache_ttl = float(cache_ttl)
        self._cache: dict = {}      # key -> expiry monotonic time
        self._lock = threading.Lock()   # handlers run on server threads

    @staticmethod
    def _escape_dn(value: str) -> str:
        """RFC 4514 attribute-value escaping: without it a username like
        'x,ou=admins' would inject extra RDNs into the templated DN."""
        out = []
        for i, ch in enumerate(value):
            if ch in ',+"\\<>;=' or (ch == "#" and i == 0) or \
                    (ch == " " and i in (0, len(value) - 1)):
                out.append("\\" + ch)
            elif ord(ch) < 0x20:
                out.append("\\%02x" % ord(ch))
            else:
                out.append(ch)
        return "".join(out)

    def authenticate(self, user: str, password: str) -> bool:
        import time
        if not password:
            return False            # RFC 4513 §5.1.2: no unauthenticated bind
        key = (user, hashlib.sha256(password.encode()).hexdigest())
        now = time.monotonic()
        with self._lock:
            exp = self._cache.get(key)
        if exp is not None and now < exp:
            return True
        dn = self.bind_template.format(user=self._escape_dn(user))
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.timeout)
            if self.use_ssl:
                ctx = _ssl.create_default_context()
                sock = ctx.wrap_socket(sock, server_hostname=self.host)
            try:
                sock.sendall(bind_request(1, dn, password))
                data = _recv_tlv(sock)
                ok = bool(data) and parse_bind_response(data) == 0
            finally:
                sock.close()
        except (OSError, ValueError, IndexError):
            ok = False
        if ok:
            with self._lock:
                if len(self._cache) >= self.CACHE_MAX:
                    self._cache = {k: e for k, e in self._cache.items()
                                   if e > now}
                    while len(self._cache) >= self.CACHE_MAX:
                        self._cache.pop(next(iter(self._cache)))
                self._cache[key] = now + self.cache_ttl
        return ok


class CustomAuthenticator:
    """Generic LoginModule SPI: a module with authenticate(user, pw)."""

    def __init__(self, module_path: str):
        import importlib
        self.mod = importlib.import_module(module_path)
        if not callable(getattr(self.mod, "authenticate", None)):
            raise ValueError(
                f"auth module {module_path!r} has no authenticate(user, "
                "password) callable")

    def authenticate(self, user: str, password: str) -> bool:
        return bool(self.mod.authenticate(user, password))


def resolve_authenticator(creds: Optional[dict] = None):
    """Build the configured authenticator (None → no auth required)."""
    from h2o3_tpu_torch.utils import config as _cfg
    method = str(_cfg.get_property("api.auth_method", "") or "").lower()
    if method in ("", "basic"):
        return BasicAuthenticator(creds) if creds else None
    if method == "ldap":
        host = _cfg.get_property("api.ldap_host", None)
        if not host:
            raise ValueError("auth_method=ldap requires "
                             "ai.h2o.api.ldap_host")
        return LdapAuthenticator(
            host, int(_cfg.get_property("api.ldap_port", 389) or 389),
            str(_cfg.get_property("api.ldap_bind_template",
                                  "uid={user}")),
            _cfg.get_bool("api.ldap_use_ssl", False))
    if method == "custom":
        mod = _cfg.get_property("api.auth_module", None)
        if not mod:
            raise ValueError("auth_method=custom requires "
                             "ai.h2o.api.auth_module")
        return CustomAuthenticator(str(mod))
    if method in ("kerberos", "spnego", "pam"):
        raise NotImplementedError(
            f"auth_method={method} needs a KDC / system PAM stack that "
            "is not available in this runtime (the reference wires these "
            "through JAAS LoginModules); use basic, ldap or custom")
    raise ValueError(f"unknown auth_method {method!r} "
                     "(basic|ldap|custom|kerberos|spnego|pam)")
