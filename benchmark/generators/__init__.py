"""Traffic generators, one per kind; a mix under ``traffic/`` names its
kind under ``"generator"`` and carries every parameter the kind reads."""
