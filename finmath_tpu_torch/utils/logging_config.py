"""Logging configuration.

Counterpart of ``finmath_tpu.utils.logging_config``, the analog of the
reference's ``logging.properties``: a logger hierarchy with a console
handler and an optional TCP socket handler. The port's hierarchy root is
``finmath_tpu_torch`` (``finmath_tpu_torch.calibration``,
``finmath_tpu_torch.native``, ...); allocation-level tracing maps to
DEBUG.
"""

from __future__ import annotations

import logging
import logging.handlers
from typing import Optional

ROOT_LOGGER = "finmath_tpu_torch"


def configure_logging(console_level: int = logging.INFO,
                      socket_host: Optional[str] = None,
                      socket_port: int = 50505,
                      socket_level: int = logging.DEBUG) -> logging.Logger:
    """Set up the ``finmath_tpu_torch`` logger like the reference's
    logging.properties: console (stderr) at the given level, optional TCP
    socket handler."""
    logger = logging.getLogger(ROOT_LOGGER)
    logger.setLevel(min(console_level, socket_level if socket_host else console_level))
    logger.handlers.clear()
    # dedicated handlers below: stop propagation so an application's root
    # handlers do not print every record a second time
    logger.propagate = False

    console = logging.StreamHandler()
    console.setLevel(console_level)
    console.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s"
    ))
    logger.addHandler(console)

    if socket_host:
        sock = logging.handlers.SocketHandler(socket_host, socket_port)
        sock.setLevel(socket_level)
        logger.addHandler(sock)
    return logger
