"""Layered INI-style runtime parameters.

The format of pyro2_tpu/util/runparams.py::

   [section]
   key = value    ; comment

Values are type-sniffed (int, float, str).  Later loads override earlier
ones; `no_new=True` refuses to create unknown keys.  Paths that don't exist
are retried relative to the pyro2_tpu_torch package root (so solver
`_defaults` resolve from anywhere).
"""

import os
import re
from pathlib import Path

from pyro2_tpu_torch.util import msg

__all__ = ["RuntimeParameters", "is_int", "is_float"]


def is_int(string):
    try:
        int(string)
    except ValueError:
        return False
    return True


def is_float(string):
    try:
        float(string)
    except ValueError:
        return False
    return True


def _get_val(value):
    if is_int(value):
        return int(value)
    if is_float(value):
        return float(value)
    return value.strip()


class RuntimeParameters:
    """A dictionary of section.key parameters with comments + usage log."""

    def __init__(self):
        self.params = {}
        self.param_comments = {}
        self.used_params = []

    def load_params(self, pfile, *, no_new=False):
        """Parse a parameter file, overriding/adding keys."""
        if not os.path.isfile(pfile):
            pfile = str(Path(__file__).resolve().parents[1] / pfile)

        try:
            f = open(pfile)
        except OSError:
            msg.fail(f"ERROR: parameter file does not exist: {pfile}")

        sec = re.compile(r'^\[(.*)\]')
        eq = re.compile(r'^([^=#]+)=([^;]+);{0,1}(.*)')

        section = ""
        with f:
            for line in f.readlines():
                if sec.search(line):
                    _, section, _ = sec.split(line)
                    section = section.strip().lower()
                elif eq.search(line):
                    _, item, value, comment, _ = eq.split(line)
                    item = item.strip().lower()
                    key = section + "." + item

                    if no_new and key not in self.params:
                        msg.warning(f"warning, key: {key} not defined")
                        continue

                    self.params[key] = _get_val(value)

                    if comment.strip() == "":
                        comment = self.param_comments.get(key, "")
                    self.param_comments[key] = comment.strip()

    def get_param(self, key):
        """The value of a runtime parameter (records usage)."""
        if not self.params:
            msg.warning("WARNING: runtime parameters not yet initialized")
            self.load_params("_defaults")
        if key not in self.used_params:
            self.used_params.append(key)
        if key in self.params:
            return self.params[key]
        raise KeyError(f"ERROR: runtime parameter {key} not found")

    def set_param(self, key, value, *, no_new=True):
        """Manually set a parameter (by default it must already exist)."""
        if not self.params:
            msg.warning("WARNING: runtime parameters not yet initialized")
            self.load_params("_defaults")
        if no_new and key in self.params:
            self.params[key] = value
            return
        if not no_new:
            self.params[key] = value
            self.param_comments[key] = ""
            return
        raise KeyError(f"ERROR: runtime parameter {key} not found")

    def print_unused_params(self):
        for key in self.params:
            if key not in self.used_params:
                msg.warning(f"parameter {key} never used")

    def print_all_params(self):
        for key in sorted(self.params.keys()):
            print(key, "=", self.params[key])
        print(" ")

    def write_params(self, f):
        """Dump all parameters as attrs of an HDF5 group."""
        grp = f.create_group("runtime parameters")
        for key in sorted(self.params.keys()):
            grp.attrs[key] = self.params[key]

    def print_paramfile(self, fname="inputs.auto"):
        """Dump an inputs-file image of the current parameters."""
        all_keys = list(self.params.keys())
        with open(fname, "w") as f:
            f.write("# automagically generated parameter file\n")
            secs = {q for (q, _) in [k.split(".", 1) for k in all_keys]}
            for sec in sorted(secs):
                keys = [q for q in all_keys if q.startswith(f"{sec}.")]
                f.write(f"\n[{sec}]\n")
                for key in keys:
                    option = key.split(".", 1)[1]
                    value = self.params[key]
                    if self.param_comments.get(key, "") != "":
                        f.write(f"{option} = {value}    "
                                f"; {self.param_comments[key]}\n")
                    else:
                        f.write(f"{option} = {value}\n")

    def print_sphinx_tables(self, outfile="params-sphinx.inc"):
        """Write Sphinx grid tables (option / value / description) of all
        parameters, one table per section, for inclusion in generated
        docs."""
        import textwrap

        wid_opt, wid_val, wid_desc = 36, 16, 50
        sep = (f"  +-{'-' * wid_opt}-+-{'-' * wid_val}-+-"
               f"{'-' * wid_desc}-+\n")
        head = (f"  +={'=' * wid_opt}=+={'=' * wid_val}=+="
                f"{'=' * wid_desc}=+\n")
        row = f"  | {{:{wid_opt}}} | {{:{wid_val}}} | {{:{wid_desc}}} |\n"

        all_keys = sorted(self.params.keys())
        secs = sorted({k.split(".", 1)[0] for k in all_keys})
        with open(outfile, "w") as f:
            for sec in secs:
                f.write(f"* section: ``[{sec}]``\n\n")
                f.write(sep)
                f.write(row.format("option", "value", "description"))
                f.write(head)
                for key in (k for k in all_keys
                            if k.startswith(f"{sec}.")):
                    option = key.split(".", 1)[1]
                    desc = textwrap.wrap(
                        self.param_comments.get(key, "").strip(), wid_desc)
                    if not desc:
                        desc = [" "]
                    f.write(row.format(f"``{option}``",
                                       f"``{str(self.params[key]).strip()}``",
                                       desc[0]))
                    for line in desc[1:]:
                        f.write(row.format(" ", " ", line))
                    f.write(sep)
                f.write("\n\n")

    def __str__(self):
        return "".join(f"{key} = {self.params[key]}\n"
                       for key in sorted(self.params.keys()))
