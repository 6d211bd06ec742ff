"""The ORB front-end."""
