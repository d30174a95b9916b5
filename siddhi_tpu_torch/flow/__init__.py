"""Flow-control helpers of the port (copies of the reference's ``flow/``)."""
