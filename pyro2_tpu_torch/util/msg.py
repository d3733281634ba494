"""ANSI-colored terminal messaging (a copy of pyro2_tpu/util/msg.py).

`fail` raises when running interactively/under pytest, and otherwise
exits with status 1.
"""

import sys


class Color:
    WARNING = "\033[33m"
    SUCCESS = "\033[32m"
    FAIL = "\033[31m"
    BOLD = "\033[1m"
    ENDC = "\033[0m"


def bold(string):
    print(Color.BOLD + string + Color.ENDC)


def warning(string):
    print(Color.WARNING + string + Color.ENDC)


def success(string):
    print(Color.SUCCESS + string + Color.ENDC)


def fail(string):
    print(Color.FAIL + string + Color.ENDC)
    if hasattr(sys, "ps1") or "pytest" in sys.modules:
        raise RuntimeError(string)
    sys.exit(1)
