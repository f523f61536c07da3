"""The sharding rule table (UCP half) of the port."""
