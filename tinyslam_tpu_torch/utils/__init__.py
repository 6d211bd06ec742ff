"""Random draws of the estimators, trajectory evaluation, the metrics
registry, profiling (``profiling``), checkpoint and resume
(``checkpoint``), and fault handling (``faults``: the back-end
``Watchdog``, ``SnapshotPolicy``, the device ``Heartbeat``).  Like the JAX
package's ``utils``, it re-exports nothing: import the module."""
