"""Engine checkpoints — port of ``repro.checkpoint``: the reference's
on-disk format (:mod:`.io`, with its own MessagePack codec, no
``msgpack`` or ``zstandard`` needed), the engine manifests and their
skeleton codec (:mod:`.engine`), and the carrier of a JAX engine
checkpoint into the port (:mod:`.from_jax`)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    FLEET_CHECKPOINT_FIELDS, latest_step, load_pytree, read_payload,
    save_pytree,
)
from repro_torch.checkpoint.engine import (  # noqa: F401
    CheckpointHalt, EngineCheckpointer, config_fingerprint, decode_state,
    encode_state, rng_state, set_rng_state,
)
