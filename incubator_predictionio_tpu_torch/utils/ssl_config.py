"""Server TLS configuration + server-key authentication config.

The port's own copy of incubator_predictionio_tpu/utils/ssl_config.py,
its imports pointed at this package.

Parity: common/.../configuration/SSLConfiguration.scala:32-70 (SSLContext
from a ``server.conf``-named keystore) and common/.../authentication/
KeyAuthentication.scala:34-72 (``ServerKey`` loaded from the same file, the
``accessKey`` query-param check for /stop,/reload).

Design delta: the JVM reference loads a JKS keystore via typesafe-config;
the Python-native equivalent is a PEM cert/key pair fed to
``ssl.SSLContext``. ``server.conf`` stays a flat ``key = value`` file (the
subset of HOCON the reference actually uses) under ``$PIO_CONF_DIR`` (or
``$PIO_HOME/conf``), with the same dotted key names re-rooted at
``pio.server.``:

    pio.server.ssl-certfile = /path/to/server.crt
    pio.server.ssl-keyfile  = /path/to/server.key
    pio.server.ssl-keyfile-pass = secret        # optional
    pio.server.key-auth-enforced = true
    pio.server.accessKey = my-server-key
"""

from __future__ import annotations

import dataclasses
import logging
import os
import ssl
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)


def conf_dir() -> Path:
    explicit = os.environ.get("PIO_CONF_DIR")
    if explicit:
        return Path(explicit)
    home = os.environ.get("PIO_HOME", os.path.expanduser("~/.pio_tpu"))
    return Path(home) / "conf"


def parse_server_conf(text: str) -> Dict[str, str]:
    """Flat ``key = value`` parser (the HOCON subset server.conf uses)."""
    out: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("//"):
            continue
        key, sep, value = line.partition("=")
        if not sep:
            continue
        value = value.strip()
        # inline comments: only when preceded by whitespace, so values may
        # still contain '#'/'//' (e.g. passwords, URLs)
        for marker in (" #", "\t#", " //", "\t//"):
            idx = value.find(marker)
            if idx != -1:
                value = value[:idx].rstrip()
        out[key.strip()] = value.strip().strip('"')
    return out


def load_server_conf(path: Optional[Path] = None) -> Dict[str, str]:
    path = path or (conf_dir() / "server.conf")
    if not path.exists():
        return {}
    return parse_server_conf(path.read_text())


@dataclasses.dataclass(frozen=True)
class SSLConfig:
    """The TLS material (SSLConfiguration.scala keystore fields)."""
    certfile: Optional[str] = None
    keyfile: Optional[str] = None
    password: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return bool(self.certfile)

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        """Build the server SSLContext (SSLConfiguration.sslContext:53-61)."""
        if not self.enabled:
            return None
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.load_cert_chain(
            certfile=self.certfile,
            keyfile=self.keyfile,
            password=self.password,
        )
        return context


@dataclasses.dataclass(frozen=True)
class ServerKeyConfig:
    """KeyAuthentication.ServerKey (KeyAuthentication.scala:36-43)."""
    auth_enforced: bool = False
    key: Optional[str] = None

    PARAM = "accessKey"

    def check(self, provided: Optional[str]) -> bool:
        """withAccessKeyFromFile semantics: pass unless enforcement is on
        and the ``accessKey`` query param mismatches."""
        if not self.auth_enforced:
            return True
        return provided is not None and provided == self.key


def load_ssl_config(conf: Optional[Dict[str, str]] = None) -> SSLConfig:
    conf = load_server_conf() if conf is None else conf
    return SSLConfig(
        certfile=conf.get("pio.server.ssl-certfile"),
        keyfile=conf.get("pio.server.ssl-keyfile"),
        password=conf.get("pio.server.ssl-keyfile-pass"),
    )


def load_server_key(conf: Optional[Dict[str, str]] = None) -> ServerKeyConfig:
    conf = load_server_conf() if conf is None else conf
    return ServerKeyConfig(
        auth_enforced=(
            conf.get("pio.server.key-auth-enforced", "false").lower() == "true"
        ),
        key=conf.get("pio.server.accessKey"),
    )
