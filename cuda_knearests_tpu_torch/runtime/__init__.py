"""The runtime: host-boundary accounting of the solve (``dispatch``) and
the supervised launch layer (``supervisor``, ``worker``), which runs jobs
in isolated worker children so a worker's death costs only that job."""
