"""TDT tank block IO backend (needs the optional ``tdt`` package).

Reads stream ``EOG1`` (ECoG) and the first ``ANIN`` row (audio) with
their sampling rates; ``save_block`` is the npz writer's.
"""

from __future__ import annotations

from .npz_blocks import save_block  # noqa: F401  (same output schema)


def load_block(block_path: str) -> dict:
    try:
        import tdt  # type: ignore
    except ImportError as exc:
        raise ImportError(
            "The 'tdt' package is required for TDT tank reading. Install it "
            "or use the 'preprocess.io.npz_blocks' backend."
        ) from exc

    block_data = tdt.read_block(block_path)
    return {
        "ecog": block_data.streams.EOG1.data,
        "audio": block_data.streams.ANIN.data[:1, :],
        "ecog_sf": block_data.streams.EOG1.fs,
        "audio_sf": block_data.streams.ANIN.fs,
    }
