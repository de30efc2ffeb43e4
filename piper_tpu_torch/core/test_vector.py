"""The canonical smoke phrase (the port's copy of
piper_tpu.core.test_vector.FIXTURE_PHONEME_IDS, held equal by a test)."""

# The canonical 14-id smoke phrase (BOS, interleaved phonemes/blanks, EOS)
# that the JAX package's benches, prewarm paths and fixtures measure.
FIXTURE_PHONEME_IDS = [1, 20, 0, 120, 0, 61, 0, 24, 0, 59, 0, 100, 0, 2]
