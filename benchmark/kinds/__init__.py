"""The kinds of traffic: each module plays the traffic files whose ``kind`` key names it."""
