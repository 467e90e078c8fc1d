"""Summarize a torch.profiler trace of the PyTorch port: the executions of
each program (a captured row of the trainer: `train_step`,
`multi_step@k4`, `d_update`, `sampler`, ...) on the device.

The trainer captures Kineto Chrome traces with --profile_dir (a window of
--profile_num_steps steps from --profile_start_step) or on demand with
--profile_trigger (touch the file mid-run), as
`<host>.<n>.pt.trace.json.gz`. This tool reads one and prints one JSON
line per program: executions, total ms, min, median and max ms per
execution. The parser is `dcgan_tpu_torch/utils/trace.py`, the one the
trainer digests its captures with in-process, so this tool and the
`perf/device/*` events cannot disagree about a trace.

    python -m dcgan_tpu_torch.train --preset celeba64 --use_pallas \\
        --pallas_fused --synthetic --profile_dir /tmp/tr --max_steps 20
    python tools/trace_summary_torch.py /tmp/tr
    python tools/trace_summary_torch.py /tmp/tr/<host>.<n>.pt.trace.json.gz

It names on stderr the track it read: "gpu" (the card's kernels and the
`record_function` ranges Kineto maps onto them) or "cpu" (a CPU run's
host-side ranges, which time host execution, not a device). A trace with
no duration events exits nonzero with a usage hint.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dcgan_tpu_torch.utils.trace import find_trace, summarize  # noqa: E402


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 1:
        print("usage: trace_summary_torch.py "
              "<trace.json.gz | profile_dir>", file=sys.stderr)
        return 2
    try:
        path = find_trace(args[0])
    except FileNotFoundError as e:
        print(f"{e} — capture one with `python -m dcgan_tpu_torch.train "
              "--profile_dir <dir>`", file=sys.stderr)
        return 1
    try:
        rows, source = summarize(path)
        if not rows:
            print(f"no duration events in {path} — capture one with "
                  "`python -m dcgan_tpu_torch.train --profile_dir <dir>` "
                  "(or touch a --profile_trigger file mid-run) and point "
                  "this tool at the dir or the *.pt.trace.json.gz",
                  file=sys.stderr)
            return 1
        print(f"{path}: the {source} track"
              + ("" if source == "gpu" else
                 " (a CPU capture times host-side execution; device "
                 "numbers need a capture on the card)"), file=sys.stderr)
        for row in rows:
            print(json.dumps(row))
    except BrokenPipeError:  # e.g. piped into head
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
