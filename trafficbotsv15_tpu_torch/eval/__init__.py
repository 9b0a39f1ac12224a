"""Validation and submission: metrics, WOMD/WOSAC post-processing, native realism, runners."""
