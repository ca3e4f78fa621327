"""Registry of named RNG streams: every generator the port makes is
accounted for (the twin of ``repro.analysis.streams``).

The bug class the reference once shipped: two independent consumers
(decode slot draws and temperature sampling) derived their per-position
randomness from the same (seed, position) — identical streams, correlated
draws.  The fix
is tagged streams; the gate that keeps it fixed is the AST sweep in
``repro_torch.analysis.rng``, which requires every
``_util.stream_generator``/``_util.position_generator`` call under
``src/repro_torch`` to be either

  * inline-tagged — its tag argument is one of the registered constants
    below (by name or by value, ``TAG + phase`` offsets included), or
  * marked — the call line (or the line above the statement) carries a
    ``# rng-stream: <name>`` comment naming a registered stream, for a
    seed's own stream (no tag) whose independence is documented here.

The port draws from ``torch.Generator`` objects seeded with splitmix64 of
(seed, tag), and ``position_generator`` folds each further counter in the
same way (``_util._mix``): the reference's ``fold_in`` chain.  Changing a
tag VALUE changes every draw of its stream (a seed break); the tests pin
the values, and the reference's four are the reference's values.

Import-light (no torch): ``_util`` takes its tag constants from here.
"""
from __future__ import annotations

import dataclasses

# ----------------------------- tag constants ------------------------------ #
# Values are part of the seed contract: changing one is a seed break.

#: The serving engine's sketched-cache slot draws, one stream per position.
SLOT_STREAM = 0x510C

#: The serving engine's temperature sampling, one stream per position.
SAMPLE_STREAM = 0x5A3E

#: Holdout-estimator rows of the adaptive growth loops.
HOLDOUT_STREAM = 0x5E1D

#: Leverage tail redraws; phase ``i`` draws from ``REFINE_STREAM + i``.
REFINE_STREAM = 0x11E7

#: k-means seeding in ``spectral_cluster`` (the port's own tag: the
#: reference splits its key there instead).
KMEANS_STREAM = 0x4B3A

#: The synthetic token stream, folded with (step, host) (the port's own
#: tag: the reference folds its data key with the step alone).
DATA_STREAM = 0xDA7A

#: Sketched gradient compression, folded with (step, leaf) (the port's own
#: tag, as for the data stream).
COMPRESS_STREAM = 0xC0DE


@dataclasses.dataclass(frozen=True)
class Stream:
    """One named RNG stream: a tag constant, or a documented seed or
    counter stream (``tag`` None)."""

    name: str
    tag: int | None
    doc: str


#: name → Stream.  Tagged streams carry their constant; the others are a
#: seed's own stream or the per-position/step folds of a tagged stream,
#: whose independence is documented here.
REGISTRY: dict[str, Stream] = {
    s.name: s
    for s in (
        Stream("serve-slots", SLOT_STREAM,
               "Engine slot draws: position_generator(seed, SLOT_STREAM, pos) "
               "in decode_slots/decode_slot_table."),
        Stream("serve-sample", SAMPLE_STREAM,
               "Engine temperature sampling: position_generator(seed, "
               "SAMPLE_STREAM, pos) — disjoint from the slot draws at the "
               "same position."),
        Stream("holdout", HOLDOUT_STREAM,
               "Holdout-estimator rows in grow_sketch_both and its sharded "
               "twin — disjoint from the slab draws of the same seed."),
        Stream("refine", REFINE_STREAM,
               "Leverage tail-refresh redraws: phase i draws from "
               "(seed, REFINE_STREAM + i)."),
        Stream("kmeans", KMEANS_STREAM,
               "k-means++ seeding in spectral_cluster: (seed, KMEANS_STREAM), "
               "disjoint from the sketch drawn from the seed itself."),
        Stream("data-step-host", DATA_STREAM,
               "Synthetic data: position_generator(seed, DATA_STREAM, step, "
               "host) — the nested fold separates hosts within a step."),
        Stream("compress-step-leaf", COMPRESS_STREAM,
               "Gradient-compression sketches: position_generator(seed, "
               "COMPRESS_STREAM, step, leaf) — per step, per leaf."),
        Stream("slot-position", None,
               "The per-position fold of serve-slots (position_generator's "
               "pos): one stream a decoded position."),
        Stream("sample-position", None,
               "The per-position fold of serve-sample: one stream a sampled "
               "position."),
        Stream("slabs", None,
               "A seed's own stream (stream_generator(seed)): the slab draws "
               "of the engine's entry points and of spectral_cluster's fixed "
               "sketch; every other consumer of the seed folds a tag."),
        Stream("probe-data", None,
               "The trace contracts' probe inputs (analysis/contracts.py), drawn "
               "from fixed seeds before the recorded call, never by the code "
               "under test."),
        Stream("init-params", None,
               "Parameter init: init_params(seed) draws every tensor in turn "
               "from one generator of the seed (on the parameters' device); "
               "no other stream is derived from the model seed."),
    )
}

#: Identifier → stream name: the spellings the AST sweep accepts as inline
#: tags (module-local aliases with a leading underscore included).
TAG_CONSTANT_TO_STREAM = {
    prefix + name: stream
    for name, stream in (
        ("SLOT_STREAM", "serve-slots"), ("SAMPLE_STREAM", "serve-sample"),
        ("HOLDOUT_STREAM", "holdout"), ("REFINE_STREAM", "refine"),
        ("KMEANS_STREAM", "kmeans"), ("DATA_STREAM", "data-step-host"),
        ("COMPRESS_STREAM", "compress-step-leaf"),
    )
    for prefix in ("", "_")
}

TAG_CONSTANT_NAMES = frozenset(TAG_CONSTANT_TO_STREAM)

#: Registered tag values (for literal-tag call sites).
TAG_VALUES = frozenset(s.tag for s in REGISTRY.values() if s.tag is not None)


def stream_for_tag(value: int) -> Stream | None:
    """The registered stream carrying tag ``value``, if any."""
    for s in REGISTRY.values():
        if s.tag == value:
            return s
    return None
