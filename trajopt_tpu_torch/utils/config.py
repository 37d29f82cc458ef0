"""Typed parameter registry, command-line parsing and the environment
overrides.

Counterpart of ``trajopt_tpu/utils/config.py`` (the reference's
``trajopt_common`` config wrapper): register typed parameters, parse them
from the command line, and read the reference's environment variables
(``TRAJOPT_LOG_THRESH``; ``TRAJOPT_CONVEX_SOLVER`` picks the QP back end).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Callable, Sequence


@dataclasses.dataclass
class Parameter:
    name: str
    default: Any
    help: str = ""
    type: Callable = None  # inferred from default if None

    @property
    def parse_type(self):
        if self.type is not None:
            return self.type
        if isinstance(self.default, bool):
            return lambda s: s.lower() in ("1", "true", "yes", "on")
        return type(self.default)


class CommandParser:
    """Parameter registry; read() parses argv (config.hpp CommandParser)."""

    def __init__(self, description: str = "trajopt_tpu_torch"):
        self._params: list[Parameter] = []
        self._description = description

    def add(self, name: str, default: Any, help: str = "", type=None):
        self._params.append(Parameter(name, default, help, type))
        return self

    def read(self, argv: Sequence[str] | None = None) -> argparse.Namespace:
        ap = argparse.ArgumentParser(description=self._description)
        for p in self._params:
            ap.add_argument(f"--{p.name.replace('_', '-')}",
                            dest=p.name, default=p.default,
                            type=p.parse_type, help=p.help)
        return ap.parse_args(argv)


def env_log_level(default: str = "INFO") -> str:
    """TRAJOPT_LOG_THRESH (logging.hpp gLogLevel env override)."""
    return os.environ.get("TRAJOPT_LOG_THRESH", default).upper()


def env_qp_backend(default: str = "jax") -> str:
    """TRAJOPT_CONVEX_SOLVER: ``'jax'`` (the on-device ADMM; the name is the
    problem documents' own), ``'ipm'`` (the interior-point QP) or
    ``'native'`` (the host reference driver with the C++ QP)."""
    return os.environ.get("TRAJOPT_CONVEX_SOLVER", default).lower()
