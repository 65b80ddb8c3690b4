"""The batched serving engine."""
