"""Fiat-Shamir: host duplex challenger, channels and the device challenger."""
