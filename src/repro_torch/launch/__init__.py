"""Process groups for the sharded extroversion field (``mesh``)."""
