"""Model core of the port: Holt-Winters, the dilated LSTM, heads, forward."""
