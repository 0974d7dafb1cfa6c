"""Run a notebook's code cells without Jupyter:

    python -m treelearn_tpu_torch.utils.notebook NOTEBOOK.ipynb

Reads the ``.ipynb`` JSON and ``exec``s its code cells in order in one
namespace, as a kernel would run them top to bottom (IPython magics and
shell lines, ``%`` / ``!``, are not supported).  A failing cell raises with
its index.
"""

from __future__ import annotations

import json
import sys


def code_cells(path: str) -> list:
    with open(path) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def run_notebook(path: str, namespace: dict = None) -> dict:
    """Execute the code cells of ``path`` in order; returns the namespace."""
    ns = {"__name__": "__main__"} if namespace is None else namespace
    for i, src in enumerate(code_cells(path)):
        try:
            exec(compile(src, f"{path}:cell{i}", "exec"), ns)
        except Exception as e:
            raise RuntimeError(f"{path}: code cell {i} failed: "
                               f"{type(e).__name__}: {e}") from e
    return ns


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    for path in args:
        run_notebook(path)
        print(f"notebook: {path} ran", flush=True)


if __name__ == "__main__":
    main()
