"""The broker task plane (parity cdn-broker/src/tasks/): listeners and
receive loops (handlers), routing core + senders, and the periodic
heartbeat / sync / whitelist tasks."""
