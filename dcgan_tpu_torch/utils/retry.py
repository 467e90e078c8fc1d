"""Bounded retry with jittered exponential backoff for transient host IO
(a copy of `dcgan_tpu/utils/retry.py::retry_io`).

A transient `OSError` on IO that is retryable by nature (checkpoint
integrity manifests, the corrupt-step rename, metric files) gets a few
spaced attempts before it becomes a real failure. Jitter is deterministic
(seeded from the site tag and the attempt number), so two processes
retrying one site still decorrelate and a run is reproducible. Each
attempt first consults the chaos hook (testing/chaos.py `io_error_once`),
which raises one OSError at the site whose tag it names.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Tuple, Type, TypeVar

from dcgan_tpu_torch.testing import chaos

T = TypeVar("T")

DEFAULT_ATTEMPTS = 3
DEFAULT_BASE_DELAY_S = 0.05
DEFAULT_MAX_DELAY_S = 2.0


def retry_io(fn: Callable[[], T], *, tag: str,
             attempts: int = DEFAULT_ATTEMPTS,
             base_delay_s: float = DEFAULT_BASE_DELAY_S,
             max_delay_s: float = DEFAULT_MAX_DELAY_S,
             retry_on: Tuple[Type[BaseException], ...] = (OSError,),
             sleep: Callable[[float], None] = time.sleep) -> T:
    """Run `fn` with up to `attempts` tries; `retry_on` failures back off
    (base * 2^i plus deterministic jitter, capped) between tries, and the
    last failure propagates unchanged. `tag` names the site in logs and is
    the chaos hook's selector (testing/chaos.py io_error_once)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(attempts):
        try:
            chaos.maybe_io_error(tag)
            return fn()
        except retry_on as e:
            if attempt == attempts - 1:
                raise
            delay = min(max_delay_s, base_delay_s * (2 ** attempt))
            delay *= 0.5 + random.Random(f"{tag}:{attempt}").random()
            print(f"[dcgan_tpu_torch] transient IO error at {tag!r} "
                  f"(attempt {attempt + 1}/{attempts}): {e} — "
                  f"retrying in {delay * 1e3:.0f} ms", flush=True)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
