"""Authentication flows (reference layer L4, cdn-proto/src/connection/auth/).

Three parties, three modules:

- ``user``    — the client side: marshal handshake then broker handshake
- ``marshal`` — verify a user, pick a broker, issue a permit
- ``broker``  — redeem user permits; mutual broker↔broker auth
"""
