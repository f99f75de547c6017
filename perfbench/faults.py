"""Stand-ins for the timed path that a correct check must refuse.

Each is a function of a configuration's ``System`` class that returns a
subclass whose timed ``call`` is broken; ``run.run_cell(...,
system_wrap=...)`` drives a whole run with it.

- :func:`control`: the reference in the program's place, computed one
  precision below the configuration's (``System.control_mode``).
- :func:`half_batch`: the second half of every batch left out (its rows
  zero), as a step that covers half the batch would leave it.
- :func:`altered`: every answer altered where it is produced (each
  detection's box shifted by a tenth of its size, its score lowered).
"""

from __future__ import annotations

import numpy as np


def control(system_cls):
    class Control(system_cls):
        def call(self, images, windows):
            out = []
            for k in range(0, images.shape[0], self.params["ref_block"]):
                out.append(self.reference(images[k:k + self.params["ref_block"]],
                                          windows[k:k + self.params["ref_block"]],
                                          self.control_mode()))
            return tuple(None if out[0][i] is None else np.concatenate([o[i] for o in out])
                         for i in range(len(out[0])))

    return Control


def half_batch(system_cls):
    class HalfBatch(system_cls):
        def call(self, images, windows):
            out = super().call(images, windows)
            half = images.shape[0] // 2
            for o in out:
                if o is not None:
                    o[half:] = 0
            return out

    return HalfBatch


def altered(system_cls):
    class Altered(system_cls):
        def call(self, images, windows):
            det, *rest = super().call(images, windows)
            det = det.copy()
            size = det[..., 2:4] - det[..., 0:2]
            det[..., 0:4] += 0.1 * np.concatenate([size, size], -1)
            det[..., 5] *= 0.9
            return (det, *rest)

    return Altered
