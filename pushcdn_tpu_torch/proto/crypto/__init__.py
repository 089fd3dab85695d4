"""Crypto & identity: signature schemes, TLS cert plumbing, deterministic RNG.

Capability parity with cdn-proto/src/crypto/ (SURVEY.md §1 L3).
"""
